"""Where the time of one training step goes, on one GPU.

    python -m qea_ocr_tpu_torch.tools.profile_step [--docs 8] [--steps 5]

At full width (UNet 32 features, CRNN hidden 256, 400x512 documents, 16
strip slots, bfloat16 policy) on the batch of `tools/bench_batch.py`:

  1. `prep_extract` + jitter, and `phase_ab`, timed with CUDA events and on
     the host clock with a synchronise (median of `--steps` steps after two
     of warm-up), and the peak device memory;
  2. the stages of the step, each run alone at the step's shapes and timed
     with CUDA events (median): they overlap nothing, so their sum against
     the whole step shows what the isolation leaves out;
  3. a `torch.profiler` trace of `--steps` steps: device time in all and per
     step, the share of a step (part 1's host time) in which the device ran
     nothing, the number of kernel launches, and the heaviest kernels by
     name;
  4. the UNet eval forward through the library layout and through the
     channel-major twin (the trainer's no-grad forwards with
     `QEA_CONV_IMPL=cmajor`): for each the device time, the launches and
     the heaviest kernels of a profiled run (`chip_smoke.py` times the two
     forwards against each other).

Prints a report and, as its last line, one JSON object with every number.
Needs a CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch import nn

from qea_ocr_tpu_torch.data import CharMap
from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.ops.ctc import ctc_loss_mean, greedy_decode
from qea_ocr_tpu_torch.ops.edit_distance import cer_from_labels
from qea_ocr_tpu_torch.ops.entropy import mean_sequence_entropy
from qea_ocr_tpu_torch.ops.text_stack import get_text_stack_batch
from qea_ocr_tpu_torch.tools.bench_batch import (
    bench_batch, extract_and_jitter, phase_ab)
from qea_ocr_tpu_torch.train.patch_steps import make_steps
from qea_ocr_tpu_torch.train.state import adam_l2
from qea_ocr_tpu_torch.utils.device import resolve_device

S = 16


def event_ms(fn, warmup: int = 2, iters: int = 7) -> float:
    """Median CUDA-event time of `fn`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _grads_off(model: nn.Module):
    for p in model.parameters():
        p.grad = None


def stages(unet, crnn, cm, b, strips, jitter, prep_opt, crnn_opt) -> dict:
    """Each stage of `phase_ab` alone, at its shapes in the step."""
    D = b["images"].shape[0]
    N = D * S
    L = cm.max_len
    out = {}
    unet.train()
    crnn.eval()

    def unet_fwd_bwd():
        _grads_off(unet)
        ((unet(b["images"]) - 1.0) ** 2).mean().backward()
    with torch.no_grad():
        out["unet_eval_forward"] = event_ms(lambda: unet.eval()(b["images"]))
        unet.train()
    out["unet_train_forward"] = event_ms(lambda: unet(b["images"]))
    out["unet_train_forward_backward"] = event_ms(unet_fwd_bwd)

    rows_a = torch.cat([strips, jitter[0]])           # phase A: 2N rows

    def crnn_a():
        _grads_off(crnn)
        crnn(rows_a).sum().backward()
    leaf = strips.clone().requires_grad_()

    def crnn_b():
        crnn(leaf).sum().backward(inputs=[leaf])
    out["crnn_forward_phase_a_rows"] = event_ms(lambda: crnn(rows_a))
    out["crnn_forward_backward_phase_a"] = event_ms(crnn_a)
    out["crnn_forward_phase_b_rows"] = event_ms(lambda: crnn(leaf))
    out["crnn_forward_backward_phase_b_inputs_only"] = event_ms(crnn_b)

    scores = crnn(strips).detach()
    labels = b["gt_labels"].reshape(N, L)
    lengths = b["gt_lengths"].reshape(N)

    def ctc_three():
        for _ in range(3):
            x = scores.clone().requires_grad_()
            ctc_loss_mean(x, labels, lengths, pad_id=cm.pad_id).backward()
    out["ctc_forward_backward_x3"] = event_ms(ctc_three)
    docs = torch.rand_like(b["images"]).requires_grad_()

    def gather():
        get_text_stack_batch(docs, b["bboxes"]).sum().backward()
    out["gather_forward_backward"] = event_ms(gather)

    def cer():
        dec, dec_len = greedy_decode(scores, pad_id=cm.pad_id)
        cer_from_labels(dec[:, :L], dec_len.clamp(max=L), labels, lengths)
        mean_sequence_entropy(scores)
    with torch.no_grad():
        out["decode_cer_entropy"] = event_ms(cer)
    unet_fwd_bwd()
    crnn_a()
    out["adam_unet"] = event_ms(prep_opt.step)
    out["adam_crnn"] = event_ms(crnn_opt.step)
    unet.eval()
    return out


def kernel_profile(fn, reps: int):
    """`reps` calls of `fn` under `torch.profiler`: the wall time (ms, host
    clock with a synchronise) and {kernel name: (device ms, launches)}.
    Kernels and device copies only: the operator events above them carry the
    same device time again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    return wall_ms, by_name


def heaviest(by_name: dict, n: int) -> list:
    return [(name[:70], ms, count) for name, (ms, count) in sorted(
        by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:n]]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--docs", type=int, default=8)
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cm = CharMap.default()
    unet = UNet(generator=torch.Generator().manual_seed(0)).to(dev)
    crnn = CRNN(cm.vocab_size,
                generator=torch.Generator().manual_seed(1)).to(dev)
    prep_opt = adam_l2(unet.parameters(), 5e-5, 5e-4)
    crnn_opt = adam_l2(crnn.parameters(), 1e-4, 5e-4)
    steps = make_steps(unet, crnn, cm, prep_optimizer=prep_opt,
                       crnn_optimizer=crnn_opt)
    b = bench_batch(cm, args.docs, S, dev)
    gen = torch.Generator(device=dev).manual_seed(3)

    def one_step():
        strips, jitter = extract_and_jitter(steps, b, gen)
        phase_ab(steps, b, strips, jitter)
        return strips, jitter

    for _ in range(2):
        strips, jitter = one_step()
    report = {"card": card, "docs": args.docs, "strips": S}
    torch.cuda.reset_peak_memory_stats()
    host = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
    report["step_host_ms"] = float(np.median(host))
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report["prep_extract_jitter_ms"] = event_ms(
        lambda: extract_and_jitter(steps, b, gen))
    report["phase_ab_ms"] = event_ms(
        lambda: phase_ab(steps, b, strips, jitter))
    report["stages_ms"] = stages(unet, crnn, cm, b, strips, jitter, prep_opt,
                                 crnn_opt)

    wall_ms, by_name = kernel_profile(one_step, args.steps)
    busy_ms = sum(ms for ms, _ in by_name.values())
    report["profile"] = {
        "steps": args.steps, "wall_ms": wall_ms, "device_ms": busy_ms,
        # the profiler's own host cost stretches its window, so the idle
        # share is also given against the unprofiled step time of part 1
        "device_idle_share_profiled": 1.0 - busy_ms / wall_ms,
        "device_ms_per_step": busy_ms / args.steps,
        "device_idle_share": 1.0 - busy_ms / args.steps
        / report["step_host_ms"],
        "device_events": sum(n for _, n in by_name.values()),
        "top_device_ms": heaviest(by_name, 12)}

    unet.eval()
    twin = unet.twin("cmajor").eval()
    report["unet_eval_forward"] = {}
    with torch.no_grad():
        for name, model in (("library", unet), ("twin", twin)):
            model(b["images"])                      # warm-up
            _, by_name = kernel_profile(lambda: model(b["images"]), args.steps)
            report["unet_eval_forward"][name] = {
                "device_ms": sum(ms for ms, _ in by_name.values()) / args.steps,
                "device_events": sum(n for _, n in by_name.values())
                // args.steps,
                "top_device_ms": [(k, ms / args.steps, n // args.steps)
                                  for k, ms, n in heaviest(by_name, 8)]}

    print(f"card: {card}; torch {torch.__version__}")
    for k, v in report.items():
        if k not in ("stages_ms", "profile", "unet_eval_forward"):
            print(f"{k}: {v}")
    for k, v in report["stages_ms"].items():
        print(f"  stage {k}: {v:.3f} ms")
    for k, v in report["profile"].items():
        if k != "top_device_ms":
            print(f"  profile {k}: {v}")
    for name, ms, count in report["profile"]["top_device_ms"]:
        print(f"  {ms:9.3f} ms  x{count:<6d} {name}")
    for layout, r in report["unet_eval_forward"].items():
        print(f"UNet eval forward, {layout}: {r['device_ms']:.3f} ms of "
              f"device time in {r['device_events']} launches")
        for name, ms, count in r["top_device_ms"]:
            print(f"  {ms:9.3f} ms  x{count:<6d} {name}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
