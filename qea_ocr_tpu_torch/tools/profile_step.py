"""Where the time of one training step goes, on one GPU.

    python -m qea_ocr_tpu_torch.tools.profile_step [--docs 8] [--steps 5]

At full width (UNet 32 features, CRNN hidden 256, 400x512 documents, 16
strip slots, bfloat16 policy) on the batch of `tools/bench_batch.py`:

  1. `prep_extract` + jitter, and `phase_ab`, timed with CUDA events and on
     the host clock with a synchronise (median of `--steps` steps after two
     of warm-up), and the peak device memory;
  2. one `torch.profiler` stretch of `--steps` steps (device activity
     only, as the benchmark traces): the program's spans
     (`utils/metrics.span`) by name, each with its count, host ms and
     stream ms a step;
  3. from the same stretch: its window, the device's busy time (the union
     of its kernels, copies and sets), the idle share, the number of
     device operations and the heaviest by name;
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

from qea_ocr_tpu_torch.data import CharMap
from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.tools.bench_batch import (
    bench_batch, extract_and_jitter, phase_ab)
from qea_ocr_tpu_torch.train.patch_steps import make_steps
from qea_ocr_tpu_torch.train.state import adam_l2
from qea_ocr_tpu_torch.utils import metrics
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


def kernel_profile(fn, reps: int):
    """`reps` calls of `fn` under `torch.profiler` with device activity
    only: the stretch's wall time (ms, host clock ended by a synchronise),
    the device's busy ms in it (the union of its operations' intervals),
    {operation name: (device ms, count)} and the program's spans of the
    stretch (drained)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    metrics.drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans = metrics.drain()
    by_name: dict = {}
    ivals = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ms, count = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, count + 1)
            ivals.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    busy_ns, end = 0, None
    for a, b in sorted(ivals):
        if end is None or a > end:
            busy_ns, end = busy_ns + b - a, b
        elif b > end:
            busy_ns, end = busy_ns + b - end, b
    return wall_ms, busy_ns / 1e6, by_name, spans


def spans_by_name(spans, steps: int) -> dict:
    """{name: {"n", "host_ms", "stream_ms"}} a step, in order of first
    appearance."""
    out: dict = {}
    for s in spans:
        r = out.setdefault(s.name, {"n": 0, "host_ms": 0.0,
                                    "stream_ms": 0.0})
        r["n"] += 1
        r["host_ms"] += s.host_ms
        r["stream_ms"] += s.stream_ms or 0.0
    return {k: {"n": v["n"] / steps, "host_ms": v["host_ms"] / steps,
                "stream_ms": v["stream_ms"] / steps}
            for k, v in out.items()}


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

    wall_ms, busy_ms, by_name, spans = kernel_profile(one_step, args.steps)
    report["spans"] = spans_by_name(spans, args.steps)
    device_ms = sum(ms for ms, _ in by_name.values())
    report["profile"] = {
        "steps": args.steps, "wall_ms": wall_ms, "busy_ms": busy_ms,
        "device_ms": device_ms, "device_ms_per_step": device_ms / args.steps,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_events": sum(n for _, n in by_name.values()),
        "top_device_ms": heaviest(by_name, 12)}

    unet.eval()
    twin = unet.twin("cmajor").eval()
    report["unet_eval_forward"] = {}
    with torch.no_grad():
        for name, model in (("library", unet), ("twin", twin)):
            model(b["images"])                      # warm-up
            _, _, by_name, _ = kernel_profile(lambda: model(b["images"]),
                                              args.steps)
            report["unet_eval_forward"][name] = {
                "device_ms": sum(ms for ms, _ in by_name.values()) / args.steps,
                "device_events": sum(n for _, n in by_name.values())
                // args.steps,
                "top_device_ms": [(k, ms / args.steps, n // args.steps)
                                  for k, ms, n in heaviest(by_name, 8)]}

    print(f"card: {card}; torch {torch.__version__}")
    for k, v in report.items():
        if k not in ("spans", "profile", "unet_eval_forward"):
            print(f"{k}: {v}")
    print("program spans, a step:        n    host ms  stream ms")
    for k, v in report["spans"].items():
        print(f"  {k:24s} {v['n']:5.1f} {v['host_ms']:10.3f} "
              f"{v['stream_ms']:10.3f}")
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
