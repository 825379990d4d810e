#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`qea_ocr_tpu_torch`) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases; any failure raises, so the exit code is non-zero:

  1. device  - the card's name and power limit (nvidia-smi), torch and CUDA
               versions. No CUDA device is an error.
  2. build   - nvcc builds `qea_ocr_tpu_torch/csrc/*.cu` into
               `qea_ocr_tpu_torch/_build/`.
  3. kernels - each kernel against its plain PyTorch version on the card,
               at the shapes the slice gives it: the strip gather bitwise
               (also on a document size the TPU kernel could not take), the
               CTC alpha recursion to a relative 1e-5 (floor 1) with
               infeasible rows exactly 1e5; median CUDA-event times of both.
  4. slice   - the full-width UNet(32) and CRNN(hidden 256, V=95) with
               seeded random weights in the bfloat16 policy:
               `make_steps(...).val_forward` on 3 batches of 8 synthetic
               400x512 documents (16 strip slots) scored with
               `compare_labels_device`, then `DocumentCleaner.clean_arrays`
               on 16 documents. Both kernels must have launched in this
               phase. Then the float32 models on the card (TF32 off) are
               held against the same models on the CPU (plain versions) on
               2 documents, and the bfloat16 policy's distance from float32
               is measured.

The line before last is the card's name and power limit, and before it a
JSON line with each kernel's launches, error and times; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# The slice's shapes: the repo's one model pair at full width.
DOC_SIZE = (400, 512)      # config.DOC_SIZE
UNET_FEATURES = 32
LSTM_HIDDEN = 256
D, S = 8, 16               # documents per batch, strip slots per document

KERNEL_REL_TOL = 1e-5      # CTC kernel vs plain, relative with a floor of 1
REF_ATOL = 1e-4            # f32 card vs f32 CPU: doc_out and strips
REF_LOSS_RTOL = 1e-4       # f32 card vs f32 CPU: loss
REF_DECODE_AGREE = 0.95    # f32 card vs f32 CPU: share of identical decodes
BF16_DOC_ATOL = 5e-2       # bf16 policy vs f32 on the card: doc_out
BF16_LOSS_RTOL = 5e-2      # bf16 policy vs f32 on the card: loss


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def median_ms(torch, fn, warmup: int = 3, iters: int = 20) -> float:
    """Median CUDA-event time of `fn` over `iters` runs after `warmup`."""
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


def check_gather(torch, dev, card):
    from qea_ocr_tpu_torch.data import PatchDocuments, collate_docs
    from qea_ocr_tpu_torch.ops.cuda import gather_cuda

    worst, timing = 0.0, None
    for doc_size, seed in ((DOC_SIZE, 10), ((200, 300), 11)):
        H, W = doc_size
        batch = collate_docs(list(PatchDocuments.synthetic(
            D, seed=seed, n_strips=12, max_strips=S, doc_size=doc_size)))
        boxes = batch.bboxes.copy()       # slots 12..15: dummy [0,0,1,1]
        boxes[0, 6:12] = [(W - 100, H - 20, W, H), (0, 0, 127, 31),
                          (0, 30, 5, 33), (W - 5, 0, W, 31),
                          (W - 10, 5, W + 20, 15),   # pokes out: edge pixels
                          (0, 0, 0, 0)]              # empty: all white
        docs = torch.from_numpy(batch.images).to(dev)
        bb = torch.from_numpy(boxes).to(dev)
        got = gather_cuda.text_stack_cuda(docs, bb)
        want = gather_cuda.text_stack_plain(docs, bb)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"gather kernel != plain at {doc_size}: "
                                 f"max abs err {err}")
        worst = max(worst, err)
        ms = median_ms(torch, lambda: gather_cuda.text_stack_cuda(docs, bb))
        plain_ms = median_ms(
            torch, lambda: gather_cuda.text_stack_plain(docs, bb))
        log(f"[kernels] gather D={D} S={S} doc {H}x{W}: bitwise equal; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median, {card})")
        if timing is None:
            timing = (ms, plain_ms)
    return worst, timing


def _ctc_inputs(torch, dev, B, seed):
    T, V, L = 31, 95, 100
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.normal(size=(T, B, V)).astype(np.float32))
    lp = torch.log_softmax(3 * logits, dim=2)
    lengths = rng.integers(1, 15, B).astype(np.int32)
    labels = np.full((B, L), V, np.int32)
    for i, n in enumerate(lengths):
        labels[i, :n] = rng.integers(1, V, n)
    lengths[0] = 0                        # empty label: the blank path
    labels[1, :10] = 42                   # 10 repeats: needs 19 frames
    lengths[1] = 10
    labels[2, :20] = 7                    # 20 repeats need 39 > 31 frames
    lengths[2] = 20
    labels[3, :40] = rng.integers(1, V, 40)   # 40 symbols > 31 frames
    lengths[3] = 40
    labels[4, :100] = rng.integers(1, V, 100)  # full L, infeasible
    lengths[4] = 100
    return (lp.to(dev), torch.from_numpy(labels).to(dev),
            torch.from_numpy(lengths).to(dev), V)


def check_ctc(torch, dev, card):
    from qea_ocr_tpu_torch.ops.cuda import ctc_cuda

    worst, timing = 0.0, None
    for B, seed in ((D * S, 20), (1536, 21)):
        lp, labels, lengths, V = _ctc_inputs(torch, dev, B, seed)
        got = ctc_cuda.ctc_nll_cuda(lp, labels, lengths, V)
        want = ctc_cuda.ctc_nll_plain(lp, labels, lengths, V)
        torch.cuda.synchronize()
        if not (got[2:5] == 1e5).all() or not (want[2:5] == 1e5).all():
            raise AssertionError(f"infeasible rows not 1e5: kernel "
                                 f"{got[2:5].tolist()}, plain "
                                 f"{want[2:5].tolist()}")
        if not torch.isfinite(got).all():
            raise AssertionError("CTC kernel returned non-finite values")
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp(min=1)).max())
        if rel > KERNEL_REL_TOL:
            raise AssertionError(f"CTC kernel vs plain at B={B}: relative "
                                 f"err {rel} > {KERNEL_REL_TOL}")
        worst = max(worst, err)
        ms = median_ms(torch, lambda: ctc_cuda.ctc_nll_cuda(
            lp, labels, lengths, V))
        plain_ms = median_ms(torch, lambda: ctc_cuda.ctc_nll_plain(
            lp, labels, lengths, V))
        log(f"[kernels] ctc T=31 V=95 L=100 B={B}: max abs err {err:.3g}, "
            f"max rel err {rel:.3g}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (median, {card})")
        if timing is None:
            timing = (ms, plain_ms)
    return worst, timing


def run_slice(torch, dev, card):
    """The inference slice at full width. Returns the kernel launch counts
    of this phase, and the models, charmap and 2 documents for the
    reference check."""
    from qea_ocr_tpu_torch.data import (
        CharMap, PatchDocuments, collate_docs, doc_batch_to)
    from qea_ocr_tpu_torch.models.crnn import CRNN
    from qea_ocr_tpu_torch.models.unet import UNet
    from qea_ocr_tpu_torch.ops.cuda import ctc_cuda, gather_cuda
    from qea_ocr_tpu_torch.ops.edit_distance import compare_labels_device
    from qea_ocr_tpu_torch.serve.cleaner import DocumentCleaner
    from qea_ocr_tpu_torch.train.patch_steps import make_steps

    cm = CharMap.default()
    unet = UNet(init_features=UNET_FEATURES,
                generator=torch.Generator().manual_seed(0)).to(dev)
    crnn = CRNN(cm.vocab_size, lstm_hidden=LSTM_HIDDEN,
                generator=torch.Generator().manual_seed(1)).to(dev)
    steps = make_steps(unet, crnn, cm)
    world = PatchDocuments.synthetic(3 * D, seed=2, n_strips=12,
                                     max_strips=S, doc_size=DOC_SIZE)
    batches = [collate_docs(world.samples[D * i:D * (i + 1)])
               for i in range(3)]
    images = [d.image for d in world.samples[:2 * D]]
    L = cm.max_len
    N = D * S

    gather_cuda.launches = 0
    ctc_cuda.launches = 0
    for i, b in enumerate(batches):
        t = doc_batch_to(b, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        doc_out, strips, dec, dec_len, loss = steps.val_forward(
            t.images, t.bboxes, t.strip_mask, t.gt_labels, t.gt_lengths)
        exact, cer_sum, cer = compare_labels_device(
            dec, dec_len, t.gt_labels.reshape(N, L),
            t.gt_lengths.reshape(N), t.strip_mask.reshape(N))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if doc_out.shape != (D, 1, *DOC_SIZE) \
                or doc_out.dtype != torch.float32:
            raise AssertionError(f"doc_out {tuple(doc_out.shape)} "
                                 f"{doc_out.dtype}")
        if strips.shape != (N, 1, 32, 128):
            raise AssertionError(f"strips {tuple(strips.shape)}")
        if dec.shape != (N, 31) or dec.dtype != torch.int32 \
                or dec_len.shape != (N,):
            raise AssertionError(f"decode {tuple(dec.shape)} {dec.dtype}")
        if not (torch.isfinite(loss) and torch.isfinite(doc_out).all()
                and torch.isfinite(cer).all()):
            raise AssertionError(f"non-finite outputs, loss {loss}")
        n_valid = int(t.strip_mask.sum())
        log(f"[slice] val_forward batch {i}: D={D} S={S} {DOC_SIZE}, loss "
            f"{float(loss):.4f}, exact {int(exact)}/{n_valid}, mean CER "
            f"{float(cer_sum) / n_valid:.4f}; {ms:.2f} ms incl. CER "
            f"(host clock, synchronised; {card})")

    cleaner = DocumentCleaner(state_dict=unet.state_dict(), device=dev,
                              batch_size=D, doc_size=DOC_SIZE,
                              unet_features=UNET_FEATURES)
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cleaned = cleaner.clean_arrays(images)
        ms = 1e3 * (time.perf_counter() - t0)
        log(f"[slice] DocumentCleaner.clean_arrays run {i}: {2 * D} docs "
            f"{DOC_SIZE} in 2 batches of {D}, {ms:.2f} ms (host clock incl. "
            f"host fit/crop; {card})")
    raw = cleaner.clean_arrays_uint8(images[:D])
    for u8, f in zip(raw, cleaned):
        if u8.dtype != np.uint8 or u8.shape != DOC_SIZE:
            raise AssertionError(f"cleaner output {u8.dtype} {u8.shape}")
        if not np.array_equal(f, u8.astype(np.float32) / 255.0):
            raise AssertionError("clean_arrays is not the uint8 output / 255")

    counts = {"gather": gather_cuda.launches, "ctc": ctc_cuda.launches}
    log(f"[slice] kernel launches in this phase: {json.dumps(counts)}")
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    return counts, unet, crnn, cm, world.samples[:2]


def check_reference(torch, dev, unet, crnn, cm, samples):
    """f32 models on the card vs the same models on the CPU (plain
    versions), and the bf16 policy vs f32 on the card, on 2 documents."""
    from qea_ocr_tpu_torch.data import collate_docs, doc_batch_to
    from qea_ocr_tpu_torch.models.crnn import CRNN
    from qea_ocr_tpu_torch.models.unet import UNet
    from qea_ocr_tpu_torch.train.patch_steps import make_steps

    small = collate_docs(samples)
    cpu = torch.device("cpu")

    def f32_steps(device):
        u = UNet(init_features=UNET_FEATURES, compute_dtype=torch.float32)
        u.load_state_dict(unet.state_dict())
        c = CRNN(cm.vocab_size, lstm_hidden=LSTM_HIDDEN,
                 compute_dtype=torch.float32)
        c.load_state_dict(crnn.state_dict())
        return make_steps(u.to(device), c.to(device), cm)

    def run(steps, device):
        t = doc_batch_to(small, device)
        out = steps.val_forward(t.images, t.bboxes, t.strip_mask,
                                t.gt_labels, t.gt_lengths)
        return [x.cpu() for x in out]

    card32 = run(f32_steps(dev), dev)
    cpu32 = run(f32_steps(cpu), cpu)
    card16 = run(make_steps(unet, crnn, cm), dev)

    doc_err = float((card32[0] - cpu32[0]).abs().max())
    strip_err = float((card32[1] - cpu32[1]).abs().max())
    loss_rel = abs(float(card32[4]) - float(cpu32[4])) / abs(float(cpu32[4]))
    agree = float((card32[2] == cpu32[2]).all(dim=1).float().mean())
    log(f"[reference] f32 card vs f32 CPU, 2 docs: doc_out max abs err "
        f"{doc_err:.3g}, strips {strip_err:.3g}, loss rel err "
        f"{loss_rel:.3g}, identical decodes {agree:.4f}")
    if doc_err > REF_ATOL or strip_err > REF_ATOL \
            or loss_rel > REF_LOSS_RTOL or agree < REF_DECODE_AGREE:
        raise AssertionError("the card's f32 slice disagrees with the CPU")
    bf_doc = float((card16[0] - card32[0]).abs().max())
    bf_loss = abs(float(card16[4]) - float(card32[4])) / abs(float(card32[4]))
    bf_agree = float((card16[2] == card32[2]).all(dim=1).float().mean())
    log(f"[reference] bf16 policy vs f32 on the card, 2 docs: doc_out max "
        f"abs err {bf_doc:.3g}, loss rel err {bf_loss:.3g}, identical "
        f"decodes {bf_agree:.4f}")
    if bf_doc > BF16_DOC_ATOL or bf_loss > BF16_LOSS_RTOL:
        raise AssertionError("the bf16 policy is further from f32 than "
                             "the stated bound")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "needs one GPU")
    # f32 comparisons on the card: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from qea_ocr_tpu_torch.ops.cuda import build
    from qea_ocr_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = gpu_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {', '.join(p.name for p in libs)} in "
        f"{time.perf_counter() - t0:.1f} s")

    gather_err, (gather_ms, gather_plain_ms) = check_gather(torch, dev, card)
    ctc_err, (ctc_ms, ctc_plain_ms) = check_ctc(torch, dev, card)

    counts, unet, crnn, cm, samples = run_slice(torch, dev, card)
    check_reference(torch, dev, unet, crnn, cm, samples)

    kernels = [
        {"name": "gather_fwd", "route": "cuda",
         "source": "qea_ocr_tpu_torch/csrc/gather.cu",
         "replaces": "qea_ocr_tpu/ops/pallas/gather_pallas.py:113",
         "launches": counts["gather"], "max_abs_err": gather_err,
         "ms": gather_ms, "plain_ms": gather_plain_ms},
        {"name": "ctc_alpha_fwd", "route": "cuda",
         "source": "qea_ocr_tpu_torch/csrc/ctc.cu",
         "replaces": "qea_ocr_tpu/ops/pallas/ctc_pallas.py:42",
         "launches": counts["ctc"], "max_abs_err": ctc_err,
         "ms": ctc_ms, "plain_ms": ctc_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
