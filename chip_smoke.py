#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`qea_ocr_tpu_torch`) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases; any failure raises, so the exit code is non-zero:

  1. device    - the card's name and power limit (nvidia-smi), torch and CUDA
                 versions. No CUDA device is an error.
  2. build     - nvcc builds `qea_ocr_tpu_torch/csrc/*.cu` into
                 `qea_ocr_tpu_torch/_build/`, one process per source. The
                 conv library's SASS must hold HGMMA (`wgmma`) and UTMALDG
                 (TMA loads) and no HMMA (`mma.sync`); ptxas's registers,
                 static shared memory and spills of every kernel (each conv
                 instantiation, the CTC and gather kernels) are logged.
  3. kernels   - first the launch floor: the device time of an empty
                 launch (`torch.cuda._sleep(0)`), back to back. Then each
                 of the five kernels against its plain PyTorch version
                 on the card, at the shapes the main paths give it: the
                 strip gather bitwise (also on a document size the TPU
                 kernel could not take) and its backward to 1e-6 absolute,
                 bitwise repeatable, with boxes that overlap and one that
                 pokes out of the document; both again on documents of
                 37x70, 400x510 and 33x129 (not multiples of the backward's
                 32x128 tile, nor of 4 in W) with boxes out of every edge
                 and corner, wholly beyond an edge, larger than a tile,
                 overlapping and empty, the forward there also at tiles of
                 17x66 (w_out % 4 != 0) and 32x130 (w_out > 128). The CTC
                 alpha recursion (NLL, and alpha over the band it writes)
                 and its beta/gradient recursion to a relative 1e-5 (floor
                 1) at B = 1, 128 and 1536 (T=31) and 64 (T=38), L = 100
                 with a full-length row, infeasible rows at exactly 1e5 and
                 gradient exactly 0, the gradient bitwise repeatable; the
                 forward without alpha at T = 200, L = 511; a T (120) whose
                 row does not fit the backward's shared memory must raise
                 before any launch. Median times: each kernel's device time
                 (launches queued behind a spin, so Python's launch cost is
                 hidden; the CTC forward with alpha, as the training step
                 calls it, and without), its time as one call from Python,
                 the plain version's time a call, the device time of
                 `F.ctc_loss` as a yardstick (never on the path), and each
                 kernel's bound from the bytes it must move.
                 The channel-major conv: the eight convs of one full-width
                 UNet eval forward (D=8), with the fused shift + ReLU
                 epilogue and without, and odd shapes at the edges of the
                 kernel's tiles (Cin 1, 6, 17, 40; Cout 5, 33, 72, 300;
                 heights that no tile height divides; widths 104, 136 and
                 200; D = 1 and 3), to a relative L2 of 6e-3 with
                 bitwise-zero output halo rows and garbage on the input's;
                 its gradient (dX through the same kernel) against the plain
                 version on the CPU; beside each fused conv three cuDNN
                 yardsticks (the conv + batch norm + ReLU chain it replaces,
                 a folded conv with bias + ReLU on NCHW tensors, the same on
                 channels-last tensors), its bound (bytes, or bfloat16
                 operations at the tensor cores' peak), its rate and its
                 share of the bound.
  4. slice     - inference at full width: UNet(32) and CRNN(hidden 256, V=95)
                 with seeded random weights in the bfloat16 policy:
                 `make_steps(...).val_forward` on 3 batches of 8 synthetic
                 400x512 documents (16 strip slots) scored with
                 `compare_labels_device`, then `DocumentCleaner.clean_arrays`
                 on 16 documents. Both forward kernels must have launched.
                 Then the float32 models on the card (TF32 off) are held
                 against the same models on the CPU (plain versions) on 2
                 documents, and the bfloat16 policy's distance from float32
                 is measured.
  5. train     - training at full width, bfloat16 policy, D=8 documents of
                 400x512 with 16 strips each (the inputs of the JAX
                 package's `bench.py`: history window 1 with decaying
                 weight, one jitter copy made by `add_gaussian_noise` from a
                 seeded CUDA generator, update_crnn off, Adam 5e-5 / 1e-4
                 with 5e-4 coupled decay): `prep_extract` + `phase_ab` four
                 times on one batch, then one `phase_ab` with micro_steps=2
                 and micro_refresh, then one `prep_pretrain_step`. Losses
                 finite, the phase-B loss of step 4 not above step 1's,
                 parameters moved, UNet batch statistics moved and the
                 CRNN's not, the CER table written at unmasked ids only, and
                 all four kernels launched the stated number of times (the
                 conv kernel never: the grad model is on the library route).
                 Then one float32 `phase_ab` on the card against the same
                 step on the CPU (plain versions) on 2 documents.
  6. trainer   - the patch trainer through `cli/patch_cli.py:main` at full
                 width on the card with `QEA_CONV_IMPL=cmajor`: synthetic
                 data, fake OCR, 16 training and 8 validation documents in
                 batches of 8 with 16 strip slots, 2 epochs, rangeCER
                 selection at 0.5, history window 3. The launch counts must
                 be 8 conv launches for each no-grad UNet forward
                 (`prep_extract`, `val_forward`) and none from the grad
                 model, and the four earlier kernels at their counts per
                 step; the query ledger must equal the budget, the losses be
                 finite, the side JSONs, PNG and checkpoints exist. The last
                 checkpoint is reloaded with its optimizer state, and the
                 twin's eval forward is timed against the vanilla one
                 (vanilla, twin, twin, vanilla) and held to it.
  7. pipeline  - the workflow around the trainer, through the CLIs at full
                 width on the card. (a) The CRNN warmup
                 (`cli/train_crnn.py`'s parser and config, with a metrics
                 directory): 256 training and 64 validation crops, batches
                 of 64, fake-OCR labels, 2 epochs: 10 CTC forward and 8
                 backward launches, nothing else; a query ledger of 320
                 crops an epoch; finite losses in its `metrics.jsonl`;
                 checkpoints (state_dict and `.optim`), the last one
                 reloaded and equal to the trainer's model. Then, on one
                 training batch (B=64, T=31, L=100: the trained CRNN's
                 log-probs and the OCR's labels), the CTC forward with alpha
                 and the backward against their plain versions to a
                 relative 1e-5 (floor 1), and a train step timed after
                 warm-up. (b) `cli/eval_crnn.py` on that checkpoint: word
                 crops (no kernel), then 8 documents in one batch (one
                 gather forward). (c) `cli/eval_prep.py` with
                 `QEA_CONV_IMPL=cmajor` on the trainer phase's last UNet
                 checkpoint: 16 documents in 2 batches of 8 with the
                 original strips' baseline: 16 conv and 4 gather forward
                 launches; the cleaned and original accuracy and CER; an
                 eval batch timed after warm-up. (d)
                 `tools/cer_seed.seed_patch` on 4 documents: 4 gather
                 forward launches (D=1, S=12); the strips the OCR read
                 bitwise equal to the plain gather on the same documents
                 and boxes; on the host, every CER equal to an edit
                 distance recomputed here from the OCR's texts (a check of
                 the CER bookkeeping, not of the gather); and whether the
                 native host library loaded. Any other launch count fails.
  8. area      - the area (word-crop) trainer through `cli/area_cli.py` at
                 full width on the card, from the warmup's checkpoint:
                 UNet(32) on the library route, 256 training and 72
                 validation crops in batches of 64 (the tail of 8 padded
                 and masked), 2 epochs, topKCER at 0.5, window 3, one jitter
                 copy, cosine rates on both models, the EMA at 0.99 after
                 one pretraining epoch. Launches: per step 3 CTC forwards
                 with alpha and 3 backwards (phase A's history CTC over
                 B*W = 192 rows, its jitter copy, phase B), 1 forward per
                 validation batch: 28 and 24, nothing else. The ledger
                 exactly 2 x (256 + 72) = 656 queries with the logged
                 counters train-only; finite losses under the JAX keys; the
                 side JSONs, the PNG and the checkpoints (Prep_model_best
                 where an epoch's accuracy beat 0); the last
                 Prep_model_* reloaded strictly and equal to the EMA. Then
                 both CTC kernels against their plain versions at phase A's
                 history shape and phase B's on one training batch, and an
                 area step (phase A + phase B, losses read) timed.
  9. parallel  - the parallel layer on one card: the `QEA_*` variables of a
                 world of one, and `patch_cli.main` makes the process group
                 (it must be NCCL on cuda:0; its set-up timed). The trainer
                 phase's run again with `--data_parallel`: the ledger equal
                 to the trainer phase's, the first step's two losses within
                 1e-5 (relative) and the epochs' losses within 1e-3, a step's
                 host time beside the single-process one. Again with
                 `--tensor_parallel 1` (FSDP2 shards on a 1x1 mesh): the
                 LSTM stored as DTensors, the same launch counts as the
                 trainer phase (8 conv launches a twin forward), the ledger
                 equal, and its last checkpoint, loaded into a plain UNet,
                 within 2e-2 of the data-parallel run's on an eval forward.
                 `train_crnn.main` and `area_cli.main` with `--data_parallel`
                 for an epoch each: ledgers as single-process.
                 `DocumentCleaner(data_parallel=True)` on 16 documents,
                 bitwise equal to single-process (the CLI's PNG input is
                 left to the CPU test `tests/test_torch_dp.py`, which runs
                 `clean_docs --data_parallel`).
                 The group is destroyed; every kernel must have launched in
                 the phase (`launches_parallel`). Two ranks cannot share one
                 card under NCCL: the 2- and 4-rank checks are the CPU
                 tests'.
 10. export    - the trainer phase's last UNet checkpoint through
                 `tools/export_model.py` on the card at (8, 1, 400, 512),
                 on both routes. The library route's artifact is loaded by
                 a Python process that cannot import the port and its
                 output held against the eager eval forward (max 2e-2,
                 mean 2e-3: the JAX export test's bounds). With
                 `QEA_CONV_IMPL=cmajor` the artifact must hold 8
                 `qea_ocr::conv_flat` nodes and the export launch nothing
                 (it traces fake tensors); a second process puts the
                 repository root on `sys.path`, imports only
                 `qea_ocr_tpu_torch.ops.conv_cmajor` (no `models`, `train`
                 or `serve` module may be loaded), loads the artifact and
                 runs it: 8 conv launches a forward, its output held
                 against the eager channel-major twin in this process to
                 the same bounds. Bytes, export, CUDA set-up, load and
                 forward times of both logged.
 11. tooling   - pruning and sweeps on the trainer phase's world (16 + 8
                 synthetic documents of 400x512, 12 strips, fake OCR, full
                 width): `tools/cer_seed` on the 16 training documents (16
                 gather forwards), `tools/prune_cli` by topk and by FL to 8
                 documents, `tools/cer_analysis` with its summary, then
                 `patch_cli.main` for one epoch on the topk artifact with
                 `QEA_CONV_IMPL=cmajor`: the trainer's documents exactly
                 the artifact's, the ledger that of 8 documents, every
                 kernel launched as one step and one validation batch
                 count, and the CTC pair held against its plain versions
                 on one batch of the run. Then `sweeps.sweep.main`, the
                 random search (no optuna on the card): 2 patch trials and
                 1 CRNN trial of one epoch each on the same world, each
                 trial's parameters those of a seed-0 random search, the
                 result's keys and best trial checked. Last
                 `tools/build_patch_dataset --mock` on 2 of the world's
                 documents written as PNG files: the copies byte for byte,
                 the GVision mock's box in each sidecar, and the port's
                 `PatchDocuments` reading both back with one strip each.

The line before last is the card's name and power limit, and before it a
JSON line with each kernel's launches, error, times and bound; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# The slice's shapes: the repo's one model pair at full width.
DOC_SIZE = (400, 512)      # config.DOC_SIZE
UNET_FEATURES = 32
LSTM_HIDDEN = 256
D, S = 8, 16               # documents per batch, strip slots per document

KERNEL_REL_TOL = 1e-5      # CTC kernels vs plain, relative with a floor of 1
GATHER_BWD_ATOL = 1e-6     # gather backward vs autograd through the plain one
ODD_TILES = ((17, 66), (32, 130))  # gather forward tile sizes beside 32x128
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12          # float32 outside the tensor cores, same sheet
BF16_FLOPS = 989e12        # bfloat16 tensor cores, dense, same sheet
CONV_REL_L2 = 6e-3         # conv kernel vs plain: relative L2 error
REF_ATOL = 1e-4            # f32 card vs f32 CPU: doc_out and strips
REF_LOSS_RTOL = 1e-4       # f32 card vs f32 CPU: loss
REF_DECODE_AGREE = 0.95    # f32 card vs f32 CPU: share of identical decodes
BF16_DOC_ATOL = 5e-2       # bf16 policy vs f32 on the card: doc_out
BF16_LOSS_RTOL = 5e-2      # bf16 policy vs f32 on the card: loss
# one float32 phase_ab on the card vs the same step on the CPU
TRAIN_LOSS_RTOL = 1e-4     # both losses
# Gradients, each tensor against its own largest entry. The tensors next to
# the loss (the UNet's output conv, the CRNN's linear layer) are sums in
# another order and nothing else. Further up, one activation within rounding
# of a ReLU or max-pool boundary may fall on the other side on the card and
# shift every gradient upstream of it by a few percent (3.8% at the
# bottleneck in one run), so those only have to agree roughly.
TRAIN_GRAD_RTOL_NEAR_LOSS = 1e-3
TRAIN_GRAD_RTOL = 0.25
NEAR_LOSS = ("conv.weight", "conv.bias", "linear.weight", "linear.bias")
# Adam's first step moves an entry by lr * sign(g), so where g is float32
# noise the two sides may step apart by 2 lr; nothing may differ by more
TRAIN_PARAM_LRS = 2.05
# expected kernel launches: one prep_extract + phase_ab, the micro-stepped
# phase_ab (2 chunks, refresh) with its prep_extract
LAUNCHES_PER_STEP = {"gather_fwd": 2, "gather_bwd": 1, "ctc_fwd": 3,
                     "ctc_bwd": 3, "conv": 0}
LAUNCHES_MICRO = {"gather_fwd": 5, "gather_bwd": 2, "ctc_fwd": 6,
                  "ctc_bwd": 6, "conv": 0}
# the trainer phase: 16 training and 8 validation documents in batches of 8,
# 2 epochs. A trainer step is one prep_extract through the twin (8 conv
# launches, one gather) and one phase_ab through the grad model (no conv
# launch; history CTC, one jitter CTC and phase B's CTC, forward and
# backward); a validation batch is one val_forward through the twin.
TRAINER_EPOCHS, TRAINER_STEPS, TRAINER_VAL_BATCHES = 2, 2, 1
CONVS_PER_FORWARD = 8
LAUNCHES_TRAINER_STEP = {"gather_fwd": 2, "gather_bwd": 1, "ctc_fwd": 3,
                         "ctc_bwd": 3, "conv": CONVS_PER_FORWARD}
LAUNCHES_VAL_BATCH = {"gather_fwd": 1, "gather_bwd": 0, "ctc_fwd": 1,
                      "ctc_bwd": 0, "conv": CONVS_PER_FORWARD}
TWIN_DOC_ATOL = 2e-3       # twin vs vanilla eval forward, bf16, sigmoid output
# the area phase: 256 training and 72 validation crops in batches of 64 (the
# tail batch of 8 padded and masked), history window 3, 2 epochs
AREA_TRAIN, AREA_VAL, AREA_BATCH, AREA_WINDOW, AREA_EPOCHS = 256, 72, 64, 3, 2
# the exported artifact vs the eager eval forward: the JAX export test's
# bounds for a bfloat16 UNet (`tests/test_export.py:38-39`)
EXPORT_MAX_ERR, EXPORT_MEAN_ERR = 2e-2, 2e-3
# the tooling phase: the trainer phase's world, pruned to half its training
# documents for one epoch; 2 patch trials and 1 CRNN trial of one epoch
TOOLING_TRAIN, TOOLING_VAL, TOOLING_STRIPS, TOOLING_KEEP = 16, 8, 12, 8
TOOLING_SEED = 42          # PatchTrainerConfig.random_seed: its world's seed
SWEEP_PATCH_TRIALS, SWEEP_CRNN_TRIALS = 2, 1
# the parallel phase against the trainer phase, one card: at a world of one
# every all-reduce is the identity, so the first step differs by rounding
# only (the global batch norm's own sums against `F.batch_norm`); after
# steps whose cuDNN backwards add in no fixed order, the epochs' losses
# agree to 1e-3; two UNets trained that way, in the bfloat16 policy,
# within the export bound
PARALLEL_FIRST_RTOL, PARALLEL_EPOCH_RTOL = 1e-5, 1e-3
PARALLEL_DOC_ATOL = EXPORT_MAX_ERR
EPOCH_LOSS_KEYS = ("train_loss", "val_loss", "CRNN_loss")
LEDGER_KEYS = ("Black-Box Calls", "Total Black-Box Calls",
               "Train + Val BB Calls", "Total Train + Val BB Calls")


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


def device_ms(torch, fn, iters: int = 20, spin_ms: float = 10.0) -> float:
    """Device time of one `fn` (ms): `iters` calls are queued behind a spin
    on the stream and then run back to back, so the host's cost of launching
    from Python (tens of microseconds a call, more than these kernels take)
    is hidden. Median of 5 such trains. Only for calls of a few launches:
    CUDA's queue of pending launches is finite."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    cycles_per_ms = 10_000_000 / start.elapsed_time(end)
    times = []
    for _ in range(5):
        torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def bound(n_bytes: float, n_flops: float,
          peak_flops: float = F32_FLOPS) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    its memory rate and the operations over their peak rate (float32 outside
    the tensor cores unless `peak_flops` says otherwise)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / peak_flops
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by


def check_gather(torch, dev, card):
    """Forward and backward gather kernels against the plain version.
    Returns their result records (timed at the first, full-width size)."""
    from qea_ocr_tpu_torch.data import PatchDocuments, collate_docs
    from qea_ocr_tpu_torch.ops.cuda import gather_cuda

    fwd = bwd = None
    worst_fwd = worst_bwd = 0.0
    for doc_size, seed in ((DOC_SIZE, 10), ((200, 300), 11)):
        H, W = doc_size
        batch = collate_docs(list(PatchDocuments.synthetic(
            D, seed=seed, n_strips=12, max_strips=S, doc_size=doc_size)))
        boxes = batch.bboxes.copy()       # slots 12..15: dummy [0,0,1,1]
        boxes[0, 6:12] = [(W - 100, H - 20, W, H), (0, 0, 127, 31),
                          (0, 30, 5, 33), (W - 5, 0, W, 31),
                          (W - 10, 5, W + 20, 15),   # pokes out: edge pixels
                          (0, 0, 0, 0)]              # empty: all white
        boxes[1, 1] = boxes[1, 0] + (3, 2, 3, 2)     # overlaps its neighbour
        docs = torch.from_numpy(batch.images).to(dev)
        bb = torch.from_numpy(boxes).to(dev)
        got = gather_cuda.text_stack_cuda(docs, bb)
        want = gather_cuda.text_stack_plain(docs, bb)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"gather kernel != plain at {doc_size}: "
                                 f"max abs err {err}")
        worst_fwd = max(worst_fwd, err)
        ms = device_ms(torch, lambda: gather_cuda.text_stack_cuda(docs, bb))
        call_ms = median_ms(torch,
                            lambda: gather_cuda.text_stack_cuda(docs, bb))
        plain_ms = median_ms(
            torch, lambda: gather_cuda.text_stack_plain(docs, bb))
        log(f"[kernels] gather D={D} S={S} doc {H}x{W}: bitwise equal; kernel "
            f"{ms:.4f} ms on the device, {call_ms:.4f} ms a call from "
            f"Python; plain {plain_ms:.4f} ms a call (median, {card})")

        # backward: the tiles' gradient back into the documents
        gen = torch.Generator(device=dev).manual_seed(seed)
        g = torch.randn(got.shape, device=dev, generator=gen)
        d_docs = gather_cuda.text_stack_bwd_cuda(g, bb, docs.shape)
        again = gather_cuda.text_stack_bwd_cuda(g, bb, docs.shape)
        leaf = docs.clone().requires_grad_()
        plain_out = gather_cuda.text_stack_plain(leaf, bb)
        (d_plain,) = torch.autograd.grad(plain_out, leaf, g, retain_graph=True)
        torch.cuda.synchronize()
        if not torch.equal(d_docs, again):
            raise AssertionError("gather backward kernel is not repeatable")
        berr = float((d_docs - d_plain).abs().max())
        if not berr <= GATHER_BWD_ATOL * max(1.0, float(d_plain.abs().max())):
            raise AssertionError(f"gather backward kernel vs plain at "
                                 f"{doc_size}: max abs err {berr}")
        edge = float(d_docs[0, 0, 5:15, W - 1].abs().sum())
        if not edge > 0:
            raise AssertionError("the poking-out box left no gradient on the "
                                 "document's edge pixels")
        worst_bwd = max(worst_bwd, berr)
        bms = device_ms(torch, lambda: gather_cuda.text_stack_bwd_cuda(
            g, bb, docs.shape))
        bcall_ms = median_ms(torch, lambda: gather_cuda.text_stack_bwd_cuda(
            g, bb, docs.shape))
        bplain_ms = median_ms(torch, lambda: torch.autograd.grad(
            plain_out, leaf, g, retain_graph=True))
        log(f"[kernels] gather backward D={D} S={S} doc {H}x{W}: max abs err "
            f"{berr:.3g} (largest gradient {float(d_plain.abs().max()):.3g}), "
            f"repeatable bitwise; kernel {bms:.4f} ms on the device, "
            f"{bcall_ms:.4f} ms a call; plain (autograd) {bplain_ms:.4f} ms "
            f"a call (median, {card})")
        if fwd is None:
            # bytes each must move: the tile cells written (read) once, the
            # document pixels under the boxes read once (every document
            # pixel written once), and the boxes
            area = int(((boxes[..., 2] - boxes[..., 0]).clip(0, 128)
                        * (boxes[..., 3] - boxes[..., 1]).clip(0, 32)).sum())
            tiles = D * S * 32 * 128
            fb, fby = bound(4 * (tiles + area) + boxes.nbytes, 0)
            bb_, bby = bound(4 * (area + D * H * W) + boxes.nbytes, area)
            fwd = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=fb,
                       bound_by=fby, library_ms=None)
            bwd = dict(ms=bms, call_ms=bcall_ms, plain_ms=bplain_ms,
                       bound_ms=bb_, bound_by=bby, library_ms=None)
        else:
            fwd[f"ms_{H}x{W}"], bwd[f"ms_{H}x{W}"] = ms, bms
    worst_bwd = max(worst_bwd, check_gather_edges(torch, dev))
    fwd["max_abs_err"], bwd["max_abs_err"] = worst_fwd, worst_bwd
    return fwd, bwd


def gather_edge_boxes(H: int, W: int) -> np.ndarray:
    """16 boxes for a document of H x W that reach every edge case of the
    gather backward's tiles: each corner and each edge poked out of, two
    boxes wholly beyond an edge (all their cells clamp onto it), a box
    larger than the 32 x 128 tile, two that overlap, an empty box, the data
    layer's dummy and one in the middle."""
    return np.array([
        (-6, -4, 10, 8), (W - 10, -5, W + 20, 6),          # top corners
        (-8, H - 6, 12, H + 9), (W - 8, H - 6, W + 12, H + 9),
        (20, -9, 60, 4), (W - 10, 5, W + 20, 15),          # top, right
        (30, H - 3, 90, H + 20), (-15, 12, 6, 20),         # bottom, left
        (W + 3, 10, W + 30, 20), (5, -40, 50, -25),        # wholly beyond
        (5, 5, 305, 65),                                   # larger than a tile
        (10, 10, 30, 25), (12, 12, 32, 27),                # overlapping
        (0, 0, 0, 0), (0, 0, 1, 1),                        # empty, dummy
        (W // 2 - 20, H // 2 - 8, W // 2 + 20, H // 2 + 8)], np.int32)


def check_gather_edges(torch, dev) -> float:
    """Both gather kernels on documents whose sizes are multiples of neither
    the backward's 32 x 128 tile nor, in W, of 4 (so the scalar stores),
    with `gather_edge_boxes` (the second document's in reverse order); the
    backward against autograd through the plain version on the CPU. Returns
    the backward's largest error."""
    from qea_ocr_tpu_torch.ops.cuda import gather_cuda

    worst = 0.0
    for i, (H, W) in enumerate(((37, 70), (400, 510), (33, 129))):
        gen = torch.Generator(device=dev).manual_seed(60 + i)
        docs = torch.rand((2, 1, H, W), device=dev, generator=gen)
        boxes = gather_edge_boxes(H, W)
        bb = torch.from_numpy(np.stack([boxes, boxes[::-1]])).to(dev)
        got = gather_cuda.text_stack_cuda(docs, bb)
        if not torch.equal(got, gather_cuda.text_stack_plain(docs, bb)):
            raise AssertionError(f"gather kernel != plain at {H}x{W}")
        # tiles whose width is not a multiple of 4 (scalar stores), or
        # wider than the 128 columns a warp covers in one pass
        for h_out, w_out in ODD_TILES:
            if not torch.equal(
                    gather_cuda.text_stack_cuda(docs, bb, h_out, w_out),
                    gather_cuda.text_stack_plain(docs, bb, h_out, w_out)):
                raise AssertionError(f"gather kernel != plain at {H}x{W}, "
                                     f"tiles {h_out}x{w_out}")
        g = torch.randn(got.shape, device=dev, generator=gen)
        d_docs = gather_cuda.text_stack_bwd_cuda(g, bb, docs.shape)
        again = gather_cuda.text_stack_bwd_cuda(g, bb, docs.shape)
        # the plain version on the CPU adds in the kernel's order; on the
        # card autograd's scatter adds in a varying one, which moves an edge
        # pixel that collects hundreds of clamped cells by ~1e-6 relative
        leaf = docs.cpu().requires_grad_()
        (d_plain,) = torch.autograd.grad(
            gather_cuda.text_stack_plain(leaf, bb.cpu()), leaf, g.cpu())
        torch.cuda.synchronize()
        err = float((d_docs.cpu() - d_plain).abs().max())
        largest = float(d_plain.abs().max())
        if not torch.equal(d_docs, again):
            raise AssertionError(f"gather backward at {H}x{W} is not "
                                 "repeatable")
        if not err <= GATHER_BWD_ATOL * max(1.0, largest):
            raise AssertionError(f"gather backward kernel vs plain at "
                                 f"{H}x{W}: max abs err {err}")
        worst = max(worst, err)
        tiles = ", ".join(f"{h}x{w}" for h, w in ((32, 128), *ODD_TILES))
        log(f"[kernels] gather edges D=2 S=16 doc {H}x{W}: forward bitwise "
            f"equal (tiles {tiles}); backward max abs err {err:.3g} (largest "
            f"gradient {largest:.3g}), repeatable bitwise")
    return worst


def _ctc_inputs(torch, dev, B, seed, T=31):
    V, L = 95, 100
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.normal(size=(T, B, V)).astype(np.float32))
    lp = torch.log_softmax(3 * logits, dim=2)
    lengths = rng.integers(1, 15, B).astype(np.int32)
    labels = np.full((B, L), V, np.int32)
    for i, n in enumerate(lengths):
        labels[i, :n] = rng.integers(1, V, n)
    special = [(0, []),                         # empty label: the blank path
               (10, [42] * 10),                 # 10 repeats: needs 19 frames
               (20, [7] * 20),                  # 20 repeats need 39 > 31
               (40, rng.integers(1, V, 40)),    # 40 symbols > 31 frames
               (100, rng.integers(1, V, 100)),  # full L: infeasible, and the
                                                # last extended position
               (6, [5, 9, 5, 9, 5, 9]),         # a symbol 3 times
               (30, 1 + np.arange(30) % 94)]    # 30 symbols in 31 frames:
                                                # the band's last positions
    for i, (n, lab) in enumerate(special[:B]):
        labels[i, :n] = lab
        lengths[i] = n
    g = rng.uniform(0.1, 2.0, B).astype(np.float32)   # upstream gradient
    return (lp.to(dev), torch.from_numpy(labels).to(dev),
            torch.from_numpy(lengths).to(dev), torch.from_numpy(g).to(dev), V)


def _ctc_library_ms(torch, lp, labels, lengths, g, V):
    """Device time of `F.ctc_loss` on the same inputs, forward and backward
    apart: a yardstick only. It differs from the port's loss: pad labels
    are an error there (replaced here), an infeasible row is inf (zeroed)
    where the port clamps to 1e5, and its gradient is taken through the
    log-softmax."""
    import torch.nn.functional as F

    T, B, _ = lp.shape
    targets = labels.clamp(max=V - 1).long()
    in_len = torch.full((B,), T, dtype=torch.long, device=lp.device)
    tg_len = lengths.long()

    def forward(x):
        return F.ctc_loss(x, targets, in_len, tg_len, blank=0,
                          reduction="none", zero_infinity=True)
    fwd_ms = device_ms(torch, lambda: forward(lp), iters=10)
    leaf = lp.clone().requires_grad_()
    loss = forward(leaf)
    bwd_ms = device_ms(torch, lambda: torch.autograd.grad(
        loss, leaf, g, retain_graph=True), iters=10)
    return fwd_ms, bwd_ms


def hold_ctc(torch, lp, labels, lengths, g, pad_id, where: str):
    """The CTC forward with alpha and the backward on its outputs against
    `_alpha_plain` and `ctc_grad_plain` on the same tensors: NLL, alpha over
    the band the kernel computes and d log-probs, each to KERNEL_REL_TOL
    relative with a floor of 1, all finite. Returns both sides' outputs and
    the largest errors."""
    from qea_ocr_tpu_torch.ops.cuda import ctc_cuda

    T, B = lp.shape[:2]
    L = labels.shape[1]
    nll, alpha = ctc_cuda.ctc_nll_cuda(lp, labels, lengths, pad_id,
                                       want_alpha=True)
    d_lp = ctc_cuda.ctc_grad_cuda(lp, labels, lengths, alpha, nll, g, pad_id)
    p_nll, p_alpha = ctc_cuda._alpha_plain(lp, labels, lengths, pad_id, 0)
    d_plain = ctc_cuda.ctc_grad_plain(lp, labels, lengths, p_alpha, p_nll, g,
                                      pad_id)
    torch.cuda.synchronize()
    if not (torch.isfinite(nll).all() and torch.isfinite(d_lp).all()):
        raise AssertionError(f"CTC kernels at {where}: non-finite values")
    # the kernel's alpha covers the band, (B, T, n): held where it computes
    # positions, s < min(n, S), which holds the band
    n = ctc_cuda.band_threads(T, L)
    if tuple(alpha.shape) != (B, T, n):
        raise AssertionError(f"alpha {tuple(alpha.shape)}, want {(B, T, n)}")
    cols = min(n, 2 * L + 1)

    def rel(got, want):
        return float(((got - want).abs() / want.abs().clamp(min=1)).max())
    errs = dict(nll_rel=rel(nll, p_nll),
                alpha_rel=rel(alpha[..., :cols],
                              p_alpha.permute(1, 0, 2)[..., :cols]),
                grad_rel=rel(d_lp, d_plain),
                nll_abs=float((nll - p_nll).abs().max()),
                grad_abs=float((d_lp - d_plain).abs().max()))
    if max(errs["nll_rel"], errs["alpha_rel"], errs["grad_rel"]) \
            > KERNEL_REL_TOL:
        raise AssertionError(f"CTC kernels vs plain at {where}: {errs} > "
                             f"{KERNEL_REL_TOL}")
    return (nll, alpha, d_lp, p_nll, p_alpha, d_plain), errs


def check_ctc(torch, dev, card):
    """Alpha and beta/gradient kernels against their plain versions at
    B = 128 (= D*S, timed; its records are returned), 1536 (timed), 1 and,
    at T = 38, 64; a T whose row does not fit the backward's shared memory
    must raise before any launch."""
    from qea_ocr_tpu_torch.ops.cuda import ctc_cuda

    fwd = bwd = None
    worst_fwd = worst_bwd = 0.0
    for B, seed, T, timed in ((D * S, 20, 31, True), (1536, 21, 31, True),
                              (1, 22, 31, False), (64, 23, 38, False)):
        lp, labels, lengths, g, V = _ctc_inputs(torch, dev, B, seed, T)
        L = labels.shape[1]
        infeasible = slice(2, 5) if B >= 5 else slice(0, 0)
        got = ctc_cuda.ctc_nll_cuda(lp, labels, lengths, V)
        want = ctc_cuda.ctc_nll_plain(lp, labels, lengths, V)
        torch.cuda.synchronize()
        if not (got[infeasible] == 1e5).all() \
                or not (want[infeasible] == 1e5).all():
            raise AssertionError(f"infeasible rows not 1e5: kernel "
                                 f"{got[infeasible].tolist()}, plain "
                                 f"{want[infeasible].tolist()}")
        if not torch.isfinite(got).all():
            raise AssertionError("CTC kernel returned non-finite values")
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp(min=1)).max())
        if rel > KERNEL_REL_TOL:
            raise AssertionError(f"CTC kernel vs plain at B={B} T={T}: "
                                 f"relative err {rel} > {KERNEL_REL_TOL}")
        worst_fwd = max(worst_fwd, err)

        # backward: the kernel's own alpha in, d log_probs out
        (nll, alpha, d_lp, p_nll, p_alpha, d_plain), errs = hold_ctc(
            torch, lp, labels, lengths, g, V, f"B={B} T={T}")
        if not torch.equal(nll, got):
            raise AssertionError("the alpha output changed the kernel's nll")
        again = ctc_cuda.ctc_grad_cuda(lp, labels, lengths, alpha, nll, g, V)
        torch.cuda.synchronize()
        if float(d_lp[:, infeasible].abs().sum()) != 0.0 \
                or float(d_plain[:, infeasible].abs().sum()) != 0.0:
            raise AssertionError("gradient of an infeasible row is not 0")
        if not torch.equal(d_lp, again):
            raise AssertionError(f"CTC backward kernel at B={B} T={T} is not "
                                 "repeatable")
        berr, brel = errs["grad_abs"], errs["grad_rel"]
        worst_bwd = max(worst_bwd, berr)
        what = (f"ctc T={T} V={V} L={L} B={B}: max abs err {err:.3g}, max "
                f"rel err {rel:.3g}; backward max abs err {berr:.3g}, max rel "
                f"err {brel:.3g} (largest gradient "
                f"{float(d_plain.abs().max()):.3g}), infeasible rows exactly "
                "0, repeatable bitwise")
        if not timed:
            log(f"[kernels] {what}")
            continue
        ms = device_ms(torch, lambda: ctc_cuda.ctc_nll_cuda(
            lp, labels, lengths, V))
        call_ms = median_ms(torch, lambda: ctc_cuda.ctc_nll_cuda(
            lp, labels, lengths, V))
        plain_ms = median_ms(torch, lambda: ctc_cuda.ctc_nll_plain(
            lp, labels, lengths, V))
        lib_fwd_ms, lib_bwd_ms = _ctc_library_ms(torch, lp, labels, lengths,
                                                 g, V)
        bms = device_ms(torch, lambda: ctc_cuda.ctc_grad_cuda(
            lp, labels, lengths, alpha, nll, g, V))
        bcall_ms = median_ms(torch, lambda: ctc_cuda.ctc_grad_cuda(
            lp, labels, lengths, alpha, nll, g, V))
        bplain_ms = median_ms(torch, lambda: ctc_cuda.ctc_grad_plain(
            lp, labels, lengths, p_alpha, p_nll, g, V))
        # the training step asks for alpha at each of its launches: that is
        # the forward's time on the main path
        alpha_ms = device_ms(torch, lambda: ctc_cuda.ctc_nll_cuda(
            lp, labels, lengths, V, want_alpha=True))
        log(f"[kernels] {what}; forward: kernel {ms:.4f} ms on the device, "
            f"{call_ms:.4f} ms a call from Python; plain {plain_ms:.4f} ms a "
            f"call; F.ctc_loss forward {lib_fwd_ms:.4f} ms on the device; "
            f"writing alpha {alpha_ms:.4f} ms on the device; backward: kernel "
            f"{bms:.4f} ms on the device, {bcall_ms:.4f} ms a call; plain "
            f"{bplain_ms:.4f} ms a call; F.ctc_loss backward {lib_bwd_ms:.4f} "
            f"ms on the device (median, {card})")
        if fwd is None:
            # bytes: log-probs, labels, lengths in, nll out; operations: one
            # 3-way log-sum-exp (3 exp, 1 log, about 8 adds, maxes and
            # compares) per step and position below each row's extended
            # length. With alpha, the alpha its only reader needs: the
            # backward reads it only below the extended length of a row
            # that is not clamped (its other rows' gradient is 0). The
            # backward needs that alpha and the emissions there: those,
            # labels, lengths, nll and the upstream gradient in, d log_probs
            # out; per such cell the log-sum-exp, an exp and 3 adds
            elen = 2 * lengths.clamp(0, L) + 1
            cells = T * int(elen.sum())
            live_cells = T * int(elen[nll < ctc_cuda.INFEASIBLE_NLL].sum())
            io = lp.nbytes + labels.nbytes + lengths.nbytes + nll.nbytes
            fb, fby = bound(io, 12 * cells)
            ab, aby = bound(io + 4 * live_cells, 12 * cells)
            bb_, bby = bound(labels.nbytes + lengths.nbytes + nll.nbytes
                             + g.nbytes + d_lp.nbytes + 8 * live_cells,
                             16 * live_cells)
            fwd = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=fb,
                       bound_by=fby, library_ms=lib_fwd_ms,
                       with_alpha_ms=alpha_ms, with_alpha_bound_ms=ab,
                       with_alpha_bound_by=aby)
            bwd = dict(ms=bms, call_ms=bcall_ms, plain_ms=bplain_ms,
                       bound_ms=bb_, bound_by=bby, library_ms=lib_bwd_ms)
        else:
            fwd[f"ms_b{B}"], bwd[f"ms_b{B}"] = ms, bms
            fwd[f"with_alpha_ms_b{B}"] = alpha_ms

    worst_fwd = max(worst_fwd, check_ctc_long(torch, dev))

    # a T beyond the backward's shared memory: refused before any launch,
    # forward included
    lp, labels, lengths, g, V = _ctc_inputs(torch, dev, 4, 24, 120)
    counts = (ctc_cuda.launches, ctc_cuda.bwd_launches)
    for call in (lambda: ctc_cuda.ctc_nll_cuda(lp, labels, lengths, V,
                                               want_alpha=True),
                 lambda: ctc_cuda.ctc_grad_cuda(
                     lp, labels, lengths, torch.zeros(
                         (4, lp.shape[0], ctc_cuda.band_threads(
                             lp.shape[0], labels.shape[1])), device=dev),
                     torch.zeros(4, device=dev), g, V)):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"T={lp.shape[0]} did not raise")
    if (ctc_cuda.launches, ctc_cuda.bwd_launches) != counts:
        raise AssertionError("a refused CTC call launched a kernel")
    log(f"[kernels] ctc T={lp.shape[0]} (backward's shared memory "
        f"{ctc_cuda.grad_smem_bytes(lp.shape[0], V, labels.shape[1])} > "
        f"{ctc_cuda.GRAD_MAX_SMEM} bytes): the alpha output and the backward "
        "raise ValueError before any launch")
    fwd["max_abs_err"], bwd["max_abs_err"] = worst_fwd, worst_bwd
    return fwd, bwd


def check_ctc_long(torch, dev) -> float:
    """The forward without alpha at the longest labels it takes, L = 511
    (2L+1 = 1023 <= 1024), and T = 200, B = 4, V = 20: a band of 416
    threads and an emission ring of several chunks. Rows: the empty label,
    150 random symbols, 200 symbols with no repeat (exactly T frames: the
    band's last positions) and 511 (infeasible: exactly 1e5). Returns the
    largest absolute error against the plain version."""
    from qea_ocr_tpu_torch.ops.cuda import ctc_cuda

    T, B, V, L = 200, 4, 20, 511
    rng = np.random.default_rng(26)
    logits = torch.from_numpy(rng.normal(size=(T, B, V)).astype(np.float32))
    lp = torch.log_softmax(3 * logits, dim=2).to(dev)
    lengths = np.array([0, 150, 200, 511], np.int32)
    labels = np.full((B, L), V, np.int32)           # pad_id = V
    labels[1, :150] = rng.integers(1, V, 150)
    labels[2, :200] = 1 + np.arange(200) % 2
    labels[3] = rng.integers(1, V, L)
    labels = torch.from_numpy(labels).to(dev)
    lengths = torch.from_numpy(lengths).to(dev)
    got = ctc_cuda.ctc_nll_cuda(lp, labels, lengths, V)
    want = ctc_cuda.ctc_nll_plain(lp, labels, lengths, V)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs().clamp(min=1)).max())
    if not (float(got[3]) == 1e5 == float(want[3])) \
            or not bool((want[:3] < 1e5).all()) or rel > KERNEL_REL_TOL:
        raise AssertionError(f"CTC forward at T={T} L={L}: kernel "
                             f"{got.tolist()}, plain {want.tolist()}")
    err = float((got - want).abs().max())
    log(f"[kernels] ctc forward without alpha T={T} V={V} L={L} B={B} "
        f"({ctc_cuda.band_threads(T, L)} threads a row): max abs err "
        f"{err:.3g}, max rel err {rel:.3g}, the infeasible row exactly 1e5")
    return err


# The channel-major convs of one UNet eval forward at full width, D=8:
# (block, Cin, Cout, H, W), in the order the forward runs them.
def conv_shapes():
    f, (H, W) = UNET_FEATURES, DOC_SIZE
    return [("enc1.1", 1, f, H, W), ("enc1.2", f, f, H, W),
            ("enc2.1", f, 2 * f, H // 2, W // 2),
            ("enc2.2", 2 * f, 2 * f, H // 2, W // 2),
            ("dec2.1", 4 * f, 2 * f, H // 2, W // 2),
            ("dec2.2", 2 * f, 2 * f, H // 2, W // 2),
            ("dec1.1", 2 * f, f, H, W), ("dec1.2", f, f, H, W)]


def ptxas_info(source: str) -> list[dict]:
    """ptxas's report (`-Xptxas -v`) on `csrc/<source>.cu`: for each kernel
    its mangled name, registers, static shared memory and spill stores."""
    from qea_ocr_tpu_torch.ops.cuda import build

    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                      "-fPIC")]
    out = subprocess.run(
        [build.find_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o",
         str(build.BUILD_DIR / f"{source}_ptxas.o"),
         str(build.CSRC_DIR / f"{source}.cu")],
        capture_output=True, text=True, check=True, timeout=600).stderr
    info = []
    for chunk in out.split("Compiling entry function '")[1:]:
        num = lambda pat: int((re.search(pat, chunk) or [0, 0])[1])
        info.append(dict(name=chunk.split("'", 1)[0],
                         registers=num(r"Used (\d+) registers"),
                         smem_bytes=num(r"(\d+) bytes smem"),
                         spill_bytes=num(r"(\d+) bytes spill stores")))
    return info


def check_build() -> dict:
    """What the kernels compiled to. The conv kernel's SASS must hold
    `wgmma` (HGMMA) and TMA loads (UTMALDG) and no `mma.sync` (HMMA).
    ptxas's registers, static shared memory and spills (`-Xptxas -v`) of
    each conv instantiation and of the CTC and gather kernels, the three
    sources compiled in parallel. Returns {kernel name: ptxas record} for
    the CTC and gather kernels and the conv's SASS and ptxas records."""
    from concurrent.futures import ThreadPoolExecutor

    from qea_ocr_tpu_torch.ops.cuda import build

    nvcc = build.find_nvcc()
    with ThreadPoolExecutor(max_workers=3) as pool:
        reports = dict(zip(("conv_cmajor", "ctc", "gather"), pool.map(
            ptxas_info, ("conv_cmajor", "ctc", "gather"))))
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
         str(build.library_path("conv_cmajor"))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    ops = {op: len(re.findall(rf"\b{op}\b", sass))
           for op in ("HGMMA", "UTMALDG", "HMMA")}
    if not ops["HGMMA"] or not ops["UTMALDG"] or ops["HMMA"]:
        raise AssertionError(f"the conv kernel's SASS: {ops}")
    ptxas = [dict(block_n=int(m[1]), registers=k["registers"],
                  spill_bytes=k["spill_bytes"])
             for k in reports["conv_cmajor"]
             if (m := re.search(r"conv_cmajor_kernelILi(\d+)EE", k["name"]))]
    log(f"[build] conv kernel SASS: {ops['HGMMA']} HGMMA, {ops['UTMALDG']} "
        f"UTMALDG, {ops['HMMA']} HMMA; ptxas per block width N: "
        + ", ".join(f"N={p['block_n']} {p['registers']} registers, "
                    f"{p['spill_bytes']} bytes spilled" for p in ptxas))
    small = {}
    for source, names in (("ctc", ("ctc_alpha_kernel",
                                   "ctc_beta_grad_kernel")),
                          ("gather", ("gather_fwd_kernel",
                                      "gather_bwd_kernel"))):
        for name in names:
            k = [k for k in reports[source] if name in k["name"]]
            if len(k) != 1:
                raise AssertionError(f"ptxas on {source}.cu reported "
                                     f"{len(k)} entries for {name}")
            small[name] = {key: k[0][key] for key in
                           ("registers", "smem_bytes", "spill_bytes")}
            log(f"[build] {source}.cu {name}: {k[0]['registers']} "
                f"registers, {k[0]['smem_bytes']} bytes of static shared "
                f"memory, {k[0]['spill_bytes']} bytes spilled")
    return dict(conv=dict(sass=ops, ptxas=ptxas), **small)


def check_conv(torch, dev, card):
    """The channel-major conv kernel against its plain version: the eight
    shapes of one full-width UNet eval forward, with and without the fused
    shift + ReLU epilogue, odd shapes, and the dX route. Returns the
    kernel's result record: times summed over the eight fused convs (what one
    eval forward launches), and each shape's own under `shapes`."""
    import torch.nn.functional as F

    from qea_ocr_tpu_torch.ops import conv_cmajor as cc

    def rel_l2(got, want):
        return float((got.float() - want.float()).norm()
                     / want.float().norm().clamp(min=1e-30))

    def halos_zero(yf, h, w):
        return bool((yf[:, :, :w] == 0).all()) \
            and bool((yf[:, :, (h + 1) * w:] == 0).all())

    def operands(seed, d, cin, cout, h, w):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((d, cin, h, w), device=dev, generator=gen)
        xf = cc.pad_flat(x)
        # halo rows are don't-cares: fill them with garbage
        xf[:, :, :w] = 1e4
        xf[:, :, (h + 1) * w:] = -1e4
        wt = (torch.randn((3, 3, cin, cout), device=dev, generator=gen)
              / (3.0 * cin ** 0.5))
        mul = 0.5 + torch.rand((cout,), device=dev, generator=gen)
        add = 0.3 * torch.randn((cout,), device=dev, generator=gen)
        return x, xf, wt, mul, add

    worst_abs = worst_rel = 0.0
    shapes = []
    cases = [(name, D, cin, cout, h, w, True)
             for name, cin, cout, h, w in conv_shapes()]
    # the edges of the kernel's tiles: input channels that are not a
    # multiple of the 16-channel chunk, output channels for each block width
    # (16, 64, 128, 2 x 256), heights that no tile height divides, widths a
    # multiple of 8 but not of the 64-pixel tile
    cases += [("odd1", 1, 1, 5, 13, 104, False),
              ("odd2", 3, 6, 33, 21, 136, False),
              ("odd3", 2, 17, 72, 9, 200, False),
              ("odd4", 1, 40, 300, 7, 72, False)]
    for i, (name, d, cin, cout, h, w, timed) in enumerate(cases):
        x, xf, wt, mul, add = operands(30 + i, d, cin, cout, h, w)
        for fused in (True, False):
            if fused:
                run = lambda: cc.conv_flat_bn_relu(xf, wt, mul, add, h, w)
                w2 = (wt.float() * mul).to(torch.bfloat16)
                want = cc.conv_flat_plain(xf, w2, add, h, w)
            else:
                run = lambda: cc.conv_flat(xf, wt, h, w)
                want = cc.conv_flat_plain(xf, wt, None, h, w)
            got = run()
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != torch.bfloat16:
                raise AssertionError(f"conv {name}: output {got.shape} "
                                     f"{got.dtype}")
            rel = rel_l2(got, want)
            err = float((got.float() - want.float()).abs().max())
            if not rel < CONV_REL_L2 or not halos_zero(got, h, w):
                raise AssertionError(
                    f"conv kernel vs plain at {name} fused={fused}: relative "
                    f"L2 {rel}, halo rows zero {halos_zero(got, h, w)}")
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            if not timed:
                log(f"[kernels] conv {name} D={d} {cin}->{cout} {h}x{w} "
                    f"fused={fused}: rel L2 {rel:.3g}, max abs err {err:.3g}, "
                    f"halo rows bitwise zero")
                continue
            ms = device_ms(torch, run, iters=10)
            if not fused:
                shapes[-1]["unfused_ms"] = ms
                log(f"[kernels] conv {name} unfused: rel L2 {rel:.3g}, max "
                    f"abs err {err:.3g}; kernel {ms:.4f} ms on the device "
                    f"(median, {card})")
                continue
            call_ms = median_ms(torch, run, iters=10)
            plain_ms = median_ms(
                torch, lambda: cc.conv_flat_plain(xf, w2, add, h, w),
                warmup=1, iters=3)
            # the library's way to the same function: a bfloat16 cuDNN conv,
            # then batch norm in float32 and ReLU, as the vanilla block does
            x16 = x.to(torch.bfloat16)
            w16 = wt.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
            rm, rv = torch.zeros_like(mul), torch.ones_like(mul) - 1e-5

            def library():
                y = F.conv2d(x16, w16, padding=1).float()
                return F.relu(F.batch_norm(y, rm, rv, mul, add, False, 0.0,
                                           1e-5)).to(torch.bfloat16)
            # the library's cheapest way: one bfloat16 cuDNN conv on the
            # folded weights with the shift as its bias, and a ReLU in place
            wf16 = w2.permute(3, 2, 0, 1).contiguous()
            add16 = add.to(torch.bfloat16)

            def library_folded():
                return F.conv2d(x16, wf16, add16, padding=1).relu_()
            # the same on channels-last tensors (converted here, outside the
            # timed call): no layout transposes inside cuDNN
            x_cl = x16.contiguous(memory_format=torch.channels_last)
            wf_cl = wf16.contiguous(memory_format=torch.channels_last)

            def library_cl():
                return F.conv2d(x_cl, wf_cl, add16, padding=1).relu_()
            for what, fn in (("chain", library), ("folded", library_folded),
                             ("channels-last", library_cl)):
                lib_rel = rel_l2(fn(), cc.unflat(want, h, w))
                if not lib_rel < 2e-2:
                    raise AssertionError(
                        f"the library yardstick ({what}) computes something "
                        f"else at {name}: {lib_rel}")
            lib_ms = device_ms(torch, library, iters=10)
            folded_ms = device_ms(torch, library_folded, iters=10)
            cl_ms = device_ms(torch, library_cl, iters=10)
            # bytes: the image rows of the input read once, the output with
            # its halo rows written once, weights and shift; operations: one
            # multiply-add per tap, input and output channel, and pixel
            n_bytes = 2 * d * cin * h * w + got.nbytes + 2 * wt.numel() \
                + 4 * cout
            n_flops = 2 * 9 * cin * cout * d * h * w
            b_ms, b_by = bound(n_bytes, n_flops, BF16_FLOPS)
            shapes.append(dict(name=name, cin=cin, cout=cout, h=h, w=w,
                               ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                               library_ms=lib_ms,
                               library_folded_ms=folded_ms,
                               library_cl_ms=cl_ms, bound_ms=b_ms,
                               bound_by=b_by, gflop=n_flops / 1e9,
                               mbytes=n_bytes / 1e6,
                               tflops=n_flops / ms / 1e9,
                               gbytes_s=n_bytes / ms / 1e6,
                               bound_share=b_ms / ms))
            log(f"[kernels] conv {name} D={d} {cin}->{cout} {h}x{w} fused: "
                f"rel L2 {rel:.3g}, max abs err {err:.3g}, halo rows bitwise "
                f"zero; kernel {ms:.4f} ms on the device, {call_ms:.4f} ms a "
                f"call from Python; plain {plain_ms:.4f} ms; cuDNN conv + "
                f"batch norm + ReLU {lib_ms:.4f} ms, cuDNN conv on folded "
                f"weights with bias + ReLU {folded_ms:.4f} ms (NCHW), "
                f"{cl_ms:.4f} ms (channels-last) on the device; bound "
                f"{b_ms:.4f} ms by {b_by} ({n_bytes / 1e6:.1f} MB, "
                f"{n_flops / 1e9:.2f} GFLOP); kernel at "
                f"{n_flops / ms / 1e9:.1f} TFLOP/s, {n_bytes / ms / 1e6:.0f} "
                f"GB/s, {100 * b_ms / ms:.1f}% of its bound (median, {card})")
        del x, xf, want, got

    # the gradient: dX through the same kernel on the rotated weights, dW by
    # a plain weight-gradient convolution; cotangents on the halo rows ignored
    d, cin, cout, h, w = 2, 6, 5, 24, 104
    x, xf, wt, _, _ = operands(50, d, cin, cout, h, w)
    gen = torch.Generator(device=dev).manual_seed(51)
    gf = torch.randn((d, cout, (h + 2) * w), device=dev, generator=gen)
    grads = {}
    for where in ("card", "cpu"):
        to = (lambda a: a.clone()) if where == "card" else (lambda a: a.cpu())
        a = to(xf).float().requires_grad_()
        b = to(wt).requires_grad_()
        out = cc.conv_flat(a, b, h, w)
        grads[where] = [t.cpu() for t in torch.autograd.grad(
            out, (a, b), to(gf).to(out.dtype))]
    torch.cuda.synchronize()
    dx_rel = rel_l2(grads["card"][0], grads["cpu"][0])
    dw_rel = rel_l2(grads["card"][1], grads["cpu"][1])
    dx = grads["card"][0]
    if not (dx_rel < CONV_REL_L2 and dw_rel < CONV_REL_L2
            and halos_zero(dx, h, w)):
        raise AssertionError(f"conv gradient on the card vs the CPU: dX rel "
                             f"L2 {dx_rel}, dW {dw_rel}, dX halo rows zero "
                             f"{halos_zero(dx, h, w)}")
    log(f"[kernels] conv gradient D={d} {cin}->{cout} {h}x{w}: dX (the kernel "
        f"on rotated weights) rel L2 {dx_rel:.3g} vs the plain version on the "
        f"CPU, halo rows bitwise zero, halo cotangents ignored; dW rel L2 "
        f"{dw_rel:.3g}")
    total = lambda key: float(sum(s_[key] for s_ in shapes))
    return dict(ms=total("ms"), call_ms=total("call_ms"),
                plain_ms=total("plain_ms"), library_ms=total("library_ms"),
                library_folded_ms=total("library_folded_ms"),
                library_cl_ms=total("library_cl_ms"),
                bound_ms=total("bound_ms"),
                bound_by=bound(1e6 * total("mbytes"), 1e9 * total("gflop"),
                               BF16_FLOPS)[1],
                unfused_ms=total("unfused_ms"), max_abs_err=worst_abs,
                max_rel_l2=worst_rel, shapes=shapes)


def run_slice(torch, dev, card):
    """The inference slice at full width. Returns the kernel launch counts
    of this phase, and the models, charmap and 2 documents for the
    reference check."""
    from qea_ocr_tpu_torch.data import (
        CharMap, PatchDocuments, collate_docs, doc_batch_to)
    from qea_ocr_tpu_torch.models.crnn import CRNN
    from qea_ocr_tpu_torch.models.unet import UNet
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

    _reset_counts()
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

    counts = _counts()
    log(f"[slice] kernel launches in this phase: {json.dumps(counts)}")
    if min(counts["gather_fwd"], counts["ctc_fwd"]) < 1:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    if counts["gather_bwd"] or counts["ctc_bwd"] or counts["conv"]:
        raise AssertionError(f"inference launched a backward kernel, or the "
                             f"library-route UNet the conv kernel: {counts}")
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


def _counts() -> dict:
    """Kernel launches since the last `_reset_counts`, by kernel."""
    from qea_ocr_tpu_torch.ops.cuda import (
        conv_cmajor_cuda, ctc_cuda, gather_cuda)

    return {"gather_fwd": gather_cuda.launches,
            "gather_bwd": gather_cuda.bwd_launches,
            "ctc_fwd": ctc_cuda.launches, "ctc_bwd": ctc_cuda.bwd_launches,
            "conv": conv_cmajor_cuda.launches}


def _reset_counts() -> None:
    from qea_ocr_tpu_torch.ops.cuda import (
        conv_cmajor_cuda, ctc_cuda, gather_cuda)

    gather_cuda.launches = gather_cuda.bwd_launches = 0
    ctc_cuda.launches = ctc_cuda.bwd_launches = 0
    conv_cmajor_cuda.launches = 0


def _full_width(torch, cm, dev, dtype):
    from qea_ocr_tpu_torch.models.crnn import CRNN
    from qea_ocr_tpu_torch.models.unet import UNet

    unet = UNet(init_features=UNET_FEATURES, compute_dtype=dtype,
                generator=torch.Generator().manual_seed(0)).to(dev)
    crnn = CRNN(cm.vocab_size, lstm_hidden=LSTM_HIDDEN, compute_dtype=dtype,
                generator=torch.Generator().manual_seed(1)).to(dev)
    return unet, crnn


def _train_steps(unet, crnn, cm):
    from qea_ocr_tpu_torch.train.patch_steps import make_steps
    from qea_ocr_tpu_torch.train.state import adam_l2

    return make_steps(
        unet, crnn, cm,
        prep_optimizer=adam_l2(unet.parameters(), 5e-5, 5e-4),
        crnn_optimizer=adam_l2(crnn.parameters(), 1e-4, 5e-4))


def run_train(torch, dev, card, cm):
    """The training path at full width in the bfloat16 policy. Returns the
    kernel launch counts of this phase."""
    from qea_ocr_tpu_torch.tools.bench_batch import (
        bench_batch, extract_and_jitter, phase_ab)

    unet, crnn = _full_width(torch, cm, dev, torch.bfloat16)
    steps = _train_steps(unet, crnn, cm)
    b = bench_batch(cm, D, S, dev, DOC_SIZE)
    gen = torch.Generator(device=dev).manual_seed(3)
    N = D * S

    def snapshot(model):
        return {k: v.clone() for k, v in model.state_dict().items()}
    unet0, crnn0 = snapshot(unet), snapshot(crnn)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        return out, ms

    _reset_counts()
    losses = []
    for i in range(4):
        before = _counts()
        (strips, jitter), ms_x = timed(
            lambda: extract_and_jitter(steps, b, gen))
        out, ms = timed(lambda: phase_ab(steps, b, strips, jitter))
        doc_out, metrics, cer_table, ent_table, loss_a = out
        after = _counts()
        step_counts = {k: after[k] - before[k] for k in after}
        if step_counts != LAUNCHES_PER_STEP:
            raise AssertionError(f"launches in step {i}: {step_counts}, "
                                 f"expected {LAUNCHES_PER_STEP}")
        if doc_out.shape != (D, 1, *DOC_SIZE) \
                or metrics["decoded"].shape != (N, 31) \
                or metrics["cers"].shape != (N,):
            raise AssertionError("phase_ab output shapes")
        if not (torch.isfinite(loss_a) and torch.isfinite(metrics["loss"])
                and torch.isfinite(doc_out).all()
                and torch.isfinite(metrics["cers"]).all()):
            raise AssertionError(f"non-finite training outputs in step {i}")
        losses.append((float(loss_a), float(metrics["loss"])))
        log(f"[train] step {i}: D={D} S={S} {DOC_SIZE} bf16, loss_a "
            f"{losses[-1][0]:.4f}, loss_b {losses[-1][1]:.4f}, mean CER "
            f"{float(metrics['cers'].mean()):.4f}; prep_extract + jitter "
            f"{ms_x:.2f} ms, phase_ab {ms:.2f} ms (host clock, "
            f"synchronised; {card})")
    if not losses[3][1] <= losses[0][1]:
        raise AssertionError(f"phase-B loss rose over 4 steps on one batch: "
                             f"{[l[1] for l in losses]}")

    # what four steps must have changed, and what they must not have
    def changed(a, b_, pick):
        keys = [k for k in a if pick(k)]
        return keys and all(not torch.equal(a[k], b_[k]) for k in keys)

    def same(a, b_, pick):
        return all(torch.equal(a[k], b_[k]) for k in a if pick(k))
    is_stat = lambda k: "running_" in k
    is_weight = lambda k: k.endswith("weight")
    unet1, crnn1 = snapshot(unet), snapshot(crnn)
    if not (changed(unet0, unet1, is_weight)
            and changed(unet0, unet1, is_stat)):
        raise AssertionError("the UNet's weights or batch statistics did not "
                             "all move")
    if not (changed(crnn0, crnn1, is_weight) and same(crnn0, crnn1, is_stat)):
        raise AssertionError("the CRNN's weights did not all move, or its "
                             "frozen batch statistics did")
    table = b["cer_table"]
    ids = b["strip_ids"].reshape(N).long()
    valid = b["strip_mask"].reshape(N)
    untouched = torch.ones_like(table, dtype=torch.bool)
    untouched[ids[valid]] = False
    if not (table[untouched] == 1.0).all() \
            or not torch.equal(table[ids[valid]], metrics["cers"][valid]):
        raise AssertionError("cer_table was not written at exactly the "
                             "unmasked strip ids")

    before = _counts()
    (strips, jitter), _ = timed(lambda: extract_and_jitter(steps, b, gen))
    out, ms = timed(lambda: phase_ab(
        steps, b, strips, jitter, micro_steps=2, micro_refresh=True))
    after = _counts()
    micro_counts = {k: after[k] - before[k] for k in after}
    if micro_counts != LAUNCHES_MICRO:
        raise AssertionError(f"launches in the micro-stepped step: "
                             f"{micro_counts}, expected {LAUNCHES_MICRO}")
    if out[0].shape != (D, 1, *DOC_SIZE) or not (
            torch.isfinite(out[4]) and torch.isfinite(out[1]["loss"])):
        raise AssertionError("micro-stepped phase_ab: shape or non-finite")
    log(f"[train] phase_ab micro_steps=2 micro_refresh: loss_a "
        f"{float(out[4]):.4f}, loss_b {float(out[1]['loss']):.4f}; "
        f"{ms:.2f} ms (host clock, synchronised; {card})")
    loss, ms = timed(lambda: steps.prep_pretrain_step(b["images"]))
    if not torch.isfinite(loss):
        raise AssertionError("prep_pretrain_step: non-finite loss")
    log(f"[train] prep_pretrain_step: loss {float(loss):.4f}; {ms:.2f} ms "
        f"(host clock, synchronised; {card})")

    counts = _counts()
    log(f"[train] kernel launches in this phase: {json.dumps(counts)}")
    want = {k: 4 * LAUNCHES_PER_STEP[k] + LAUNCHES_MICRO[k] for k in counts}
    if counts != want:
        raise AssertionError(f"launches in the train phase {counts}, "
                             f"expected {want}")
    return counts


def check_train_reference(torch, dev, cm):
    """One float32 phase_ab on the card (TF32 off) against the same step on
    the CPU (plain versions), 2 documents at full width."""
    from qea_ocr_tpu_torch.tools.bench_batch import bench_batch, phase_ab

    cpu = torch.device("cpu")
    results = {}
    for name, device in (("card", dev), ("cpu", cpu)):
        unet, crnn = _full_width(torch, cm, device, torch.float32)
        steps = _train_steps(unet, crnn, cm)
        b = bench_batch(cm, 2, S, device, DOC_SIZE)
        _, strips = steps.prep_extract(b["images"], b["bboxes"])
        # the same jitter on both sides: the two generators' streams differ
        noise = torch.from_numpy(np.random.default_rng(4).normal(
            0, 0.05, (1, *strips.shape)).astype(np.float32)).to(device)
        jitter = (strips[None] - noise).clamp(0, 1)
        p0 = {k: p.detach().clone().cpu()
              for m in (unet, crnn) for k, p in m.named_parameters()}
        doc_out, metrics, _, _, loss_a = phase_ab(steps, b, strips, jitter)
        results[name] = dict(
            loss_a=float(loss_a), loss_b=float(metrics["loss"]),
            doc_out=doc_out.cpu(),
            grads=[(k, p.grad.cpu()) for m in (unet, crnn)
                   for k, p in m.named_parameters() if p.grad is not None],
            moved=[(k, p.detach().cpu() - p0[k]) for m in (unet, crnn)
                   for k, p in m.named_parameters()],
            lr={**{k: 5e-5 for k, _ in unet.named_parameters()},
                **{k: 1e-4 for k, _ in crnn.named_parameters()}})
    card, ref = results["card"], results["cpu"]
    rel_a = abs(card["loss_a"] - ref["loss_a"]) / abs(ref["loss_a"])
    rel_b = abs(card["loss_b"] - ref["loss_b"]) / abs(ref["loss_b"])
    doc_err = float((card["doc_out"] - ref["doc_out"]).abs().max())
    grad_rel, grad_at, near_rel = 0.0, "", 0.0
    for (k, g), (_, r) in zip(card["grads"], ref["grads"]):
        rel = float((g - r).abs().max() / r.abs().max().clamp(min=1e-12))
        if k in NEAR_LOSS:
            near_rel = max(near_rel, rel)
        if rel > grad_rel:
            grad_rel, grad_at = rel, k
    step_err, step_at, close, total = 0.0, "", 0, 0
    for (k, d), (_, r) in zip(card["moved"], ref["moved"]):
        diff = (d - r).abs()
        lrs = float(diff.max()) / ref["lr"][k]
        if lrs > step_err:
            step_err, step_at = lrs, k
        close += int((diff <= 0.01 * ref["lr"][k]).sum())
        total += diff.numel()
    log(f"[reference] f32 phase_ab, card vs CPU, 2 docs: loss_a rel err "
        f"{rel_a:.3g}, loss_b rel err {rel_b:.3g}, doc_out max abs err "
        f"{doc_err:.3g}; largest gradient difference {grad_rel:.3g} of its "
        f"tensor's largest entry ({grad_at}, {len(card['grads'])} tensors), "
        f"{near_rel:.3g} on the tensors next to the loss; "
        f"largest parameter-step difference {step_err:.3g} learning rates "
        f"({step_at}), {close / total:.4f} of {total} entries within 0.01 "
        f"learning rates")
    if rel_a > TRAIN_LOSS_RTOL or rel_b > TRAIN_LOSS_RTOL \
            or doc_err > REF_ATOL or grad_rel > TRAIN_GRAD_RTOL \
            or near_rel > TRAIN_GRAD_RTOL_NEAR_LOSS \
            or step_err > TRAIN_PARAM_LRS or close < 0.9 * total:
        raise AssertionError("the card's f32 training step disagrees with "
                             "the CPU's")


@contextlib.contextmanager
def conv_impl_cmajor():
    """`QEA_CONV_IMPL=cmajor` inside the block (UNets built there send
    their no-grad forwards through the conv kernel), as before after it."""
    before = os.environ.get("QEA_CONV_IMPL")
    os.environ["QEA_CONV_IMPL"] = "cmajor"
    try:
        yield
    finally:
        if before is None:
            del os.environ["QEA_CONV_IMPL"]
        else:
            os.environ["QEA_CONV_IMPL"] = before


def trainer_launches(steps: int = TRAINER_STEPS,
                     val_batches: int = TRAINER_VAL_BATCHES,
                     runs: int = TRAINER_EPOCHS) -> dict:
    """The kernel launches of `runs` epochs (or trials) of `steps` trainer
    steps and `val_batches` validation batches; by default one run of the
    trainer phase's configuration."""
    return {k: runs * (steps * LAUNCHES_TRAINER_STEP[k]
                       + val_batches * LAUNCHES_VAL_BATCH[k])
            for k in LAUNCHES_TRAINER_STEP}


def run_trainer(torch, dev, card, exp):
    """The patch trainer through its CLI at full width on the card, the
    no-grad twin on the channel-major conv kernel, writing under `exp`.
    Returns the kernel launch counts of this phase, the twin-vs-vanilla
    reading, the last epoch's UNet checkpoint and the run's argv, records
    and step losses (for the parallel phase)."""
    import glob

    from qea_ocr_tpu_torch.cli import patch_cli
    from qea_ocr_tpu_torch.data import PatchDocuments, collate_docs
    from qea_ocr_tpu_torch.models.unet import UNet
    from qea_ocr_tpu_torch.train.state import adam_l2
    from qea_ocr_tpu_torch.utils.io import load_checkpoint

    n_train, n_val, strips_per_doc, prop = 16, 8, 12, 0.5
    argv = ["--device", "cuda", "--ocr", "Fake", "--dataset", "synthetic",
            "--epoch", str(TRAINER_EPOCHS), "--batch_docs", str(D),
            "--max_strips", str(S), "--synthetic_train_docs",
            str(n_train), "--synthetic_val_docs", str(n_val),
            "--synthetic_strips_per_doc", str(strips_per_doc),
            "--doc_size", *map(str, DOC_SIZE),
            "--minibatch_subset", "rangeCER",
            "--minibatch_subset_prop", str(prop), "--window_size", "3",
            "--inner_limit", "2", "--inner_limit_skip",
            "--unet_features", str(UNET_FEATURES),
            "--lstm_hidden", str(LSTM_HIDDEN), "--exp_base_path", exp]
    _reset_counts()
    with conv_impl_cmajor():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = patch_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = _counts()
    want = trainer_launches()
    log(f"[trainer] kernel launches in this phase: {json.dumps(counts)}")
    if counts != want:
        raise AssertionError(f"launches in the trainer phase {counts}, "
                             f"expected {want}")

    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    # the query ledger: per document ceil(12 * (1 - 0.5)) = 6 strips,
    # queried once clean and once jittered; validation reads every strip
    train_calls = n_train * int(np.ceil(strips_per_doc * (1 - prop))) * 2
    val_calls = n_val * strips_per_doc
    if len(recs) != TRAINER_EPOCHS:
        raise AssertionError(f"{len(recs)} epochs logged")
    for i, rec in enumerate(recs):
        if rec["Black-Box Calls"] != train_calls \
                or rec["Train + Val BB Calls"] != train_calls + val_calls \
                or rec["Total Train + Val BB Calls"] != \
                (i + 1) * (train_calls + val_calls):
            raise AssertionError(f"query ledger of epoch {i}: {rec}")
        if not all(np.isfinite(rec[k]) for k in (
                "train_loss", "val_loss", "CRNN_loss", "CRNN_CER")):
            raise AssertionError(f"non-finite losses in epoch {i}: {rec}")
        log(f"[trainer] epoch {i}: {rec['time/epoch_s']:.2f} s (host "
            f"clock: {TRAINER_STEPS} steps of {D} documents, side JSONs, "
            f"validation of {n_val}); train_loss "
            f"{rec['train_loss']:.4f}, val_loss {rec['val_loss']:.4f}, "
            f"CRNN_loss {rec['CRNN_loss']:.4f}, OCR queries "
            f"{rec['Black-Box Calls']} + {val_calls} ({card})")
    # the trainer's own stage clock, last epoch alone (the totals are
    # cumulative): host time, each stage ending in a host read or a copy
    stages = {k[len("time/"):-len("_total_s")]:
              recs[-1][k] - recs[-2].get(k, 0.0)
              for k in recs[-1] if k.endswith("_total_s")}
    log(f"[trainer] patch_cli.main: {TRAINER_EPOCHS} epochs with set-up "
        f"and checkpoints in {seconds:.2f} s; stages of the last epoch "
        f"(host clock, ms, {TRAINER_STEPS} steps): " + ", ".join(
            f"{k} {1e3 * v:.1f}" for k, v in sorted(stages.items())))
    for name in ("tracked_labels/tracked_labels_current.json",
                 "selected_samples/selected_samples_current.json",
                 "cers/all_cers.json", "img_out/out_1.png",
                 "ckpts/CRNN_model_1", "params.txt"):
        if not os.path.exists(os.path.join(exp, name)):
            raise AssertionError(f"the trainer did not write {name}")

    # a checkpoint reloads, optimizer state included, and the twin over
    # it agrees with the vanilla forward
    ckpt = [p for p in glob.glob(os.path.join(
        exp, "ckpts", f"Prep_model_{TRAINER_EPOCHS - 1}_*"))
        if not p.endswith(".optim")][0]
    vanilla = UNet(init_features=UNET_FEATURES, conv_impl="xla").to(dev)
    opt = adam_l2(vanilla.parameters(), 5e-5, 5e-4)
    load_checkpoint(ckpt, vanilla, opt)
    if not opt.state_dict()["state"]:
        raise AssertionError("the checkpoint's optimizer state is empty")
    vanilla.eval()
    twin = vanilla.twin("cmajor").eval()
    docs = torch.from_numpy(collate_docs(list(PatchDocuments.synthetic(
        D, seed=60, n_strips=12, max_strips=S, doc_size=DOC_SIZE))).images
    ).to(dev)
    with torch.no_grad():
        _reset_counts()
        a, b = vanilla(docs), twin(docs)
        torch.cuda.synchronize()
        if _counts()["conv"] != CONVS_PER_FORWARD:
            raise AssertionError("the twin's forward is not 8 conv launches "
                                 "and the vanilla one none")
        diff = float((a - b).abs().max())
        if not (torch.isfinite(b).all() and diff < TWIN_DOC_ATOL):
            raise AssertionError(f"twin vs vanilla eval forward: max abs "
                                 f"difference {diff}")
        order = (vanilla, twin, twin, vanilla)
        times = [median_ms(torch, lambda m=m: m(docs), iters=10)
                 for m in order]
    vanilla_ms = min(times[0], times[3])
    twin_ms = min(times[1], times[2])
    log(f"[trainer] UNet eval forward D={D} {DOC_SIZE} bf16 on the reloaded "
        f"checkpoint: vanilla (cuDNN) {times[0]:.3f} / {times[3]:.3f} ms, "
        f"twin (conv kernel) {times[1]:.3f} / {times[2]:.3f} ms (medians of "
        f"10, CUDA events, order vanilla twin twin vanilla); max abs "
        f"difference {diff:.3g} ({card})")
    _reset_counts()
    single = dict(argv=argv, records=recs, step_losses=trainer.step_losses,
                  seconds=seconds)
    return counts, dict(vanilla_ms=vanilla_ms, twin_ms=twin_ms,
                        max_abs_diff=diff, seconds=seconds,
                        epoch_s=[r["time/epoch_s"] for r in recs],
                        last_epoch_stage_s=stages), ckpt, single


def _expect(phase: str, want: dict, tag: str = "pipeline") -> dict:
    """The launch counts since the last reset, which must equal `want`
    (kernels not named there: 0). Resets the counts."""
    counts = _counts()
    full = {k: want.get(k, 0) for k in counts}
    log(f"[{tag}] {phase}: kernel launches {json.dumps(counts)}")
    if counts != full:
        raise AssertionError(f"launches in {phase}: {counts}, expected "
                             f"{full}")
    _reset_counts()
    return counts


def _host_ms(torch, fn, iters: int = 5) -> float:
    """Median host-clock time (ms) of `fn` ending in a synchronise."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _edit_distance(a: str, b: str) -> int:
    """Levenshtein distance of two strings, one DP row at a time."""
    row = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, cb in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1,
                                       prev + (ca != cb))
    return row[-1]


def run_pipeline(torch, dev, card, work, prep_ckpt):
    """The user's workflow around the trainer, through the CLIs at full
    width on the card: the CRNN warmup, the CRNN evaluator on its
    checkpoint, the UNet evaluator on the trainer phase's checkpoint
    `prep_ckpt` with the channel-major conv, and the CER seed of 4
    documents, with the CTC and gather kernels held against their plain
    versions at the shapes the warmup and the CER seed give them. Returns
    the kernel launch counts of the whole phase and its readings."""
    import dataclasses
    import glob

    from qea_ocr_tpu_torch.cli import eval_crnn, eval_prep, train_crnn
    from qea_ocr_tpu_torch.eval.eval_prep import EvalPrep
    from qea_ocr_tpu_torch.data import (
        PatchDocuments, collate_docs, collate_words)
    from qea_ocr_tpu_torch.models.crnn import CRNN
    from qea_ocr_tpu_torch.ocr.base import get_ocr_helper
    from qea_ocr_tpu_torch.ocr.engine import OcrQueryEngine
    from qea_ocr_tpu_torch.ops.cuda import gather_cuda
    from qea_ocr_tpu_torch.tools.cer_seed import seed_patch
    from qea_ocr_tpu_torch.train.crnn_trainer import TrainCRNN
    from qea_ocr_tpu_torch.utils import native
    from qea_ocr_tpu_torch.utils.charmap import CharMap
    from qea_ocr_tpu_torch.utils.io import load_checkpoint

    total = {}
    readings = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # (a) the warmup: 256 training crops in 4 steps of 64 and 64 validation
    # crops in one batch, 2 epochs; a step is one CTC forward (with alpha)
    # and one backward, a validation batch one forward. Built as the CLI's
    # `main` builds it, with a metrics directory (the CLI has no flag for
    # one, as the JAX package's has none)
    crnn_dir = os.path.join(work, "crnn")
    n_train, n_val, batch, epochs = 256, 64, 64, 2
    steps, val_batches = n_train // batch, -(-n_val // batch)
    cfg = dataclasses.replace(train_crnn.config_from_args(
        train_crnn.build_parser().parse_args([
            "--device", "cuda", "--dataset", "synthetic", "--ocr", "Fake",
            "--lstm_hidden", str(LSTM_HIDDEN), "--batch_size", str(batch),
            "--synthetic_train_size", str(n_train),
            "--synthetic_val_size", str(n_val), "--epoch", str(epochs),
            "--std", "3", "--crnn_model_path",
            os.path.join(crnn_dir, "model")])), log_dir=crnn_dir)
    _reset_counts()
    t0 = time.perf_counter()
    trainer = TrainCRNN(cfg)
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    add(_expect("warmup", {"ctc_fwd": epochs * (steps + val_batches),
                           "ctc_bwd": epochs * steps}))
    if trainer.ocr.total_calls != epochs * (n_train + n_val) \
            or trainer.ocr.count_calls != trainer.ocr.total_calls:
        raise AssertionError(f"warmup query ledger {trainer.ocr.total_calls},"
                             f" expected {epochs * (n_train + n_val)}")
    with open(os.path.join(crnn_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if len(records) != epochs or not all(
            np.isfinite(r[k]) for r in records
            for k in ("train_loss", "val_loss", "CRNN_CER")):
        raise AssertionError(f"warmup epochs: {records}")
    for r in records:
        log(f"[pipeline] warmup epoch {r['Epoch']}: train_loss "
            f"{r['train_loss']:.4f}, val_loss {r['val_loss']:.4f}, "
            f"CRNN-vs-OCR accuracy {r['CRNN_accuracy']:.4f}, CER "
            f"{r['CRNN_CER']:.4f}, queries {r['Total Black-Box Calls']}")
    ckpts = [p for p in glob.glob(os.path.join(crnn_dir,
                                               f"model_{epochs - 1}_*"))
             if not p.endswith(".optim")]
    if len(ckpts) != 1 or not os.path.exists(ckpts[0] + ".optim"):
        raise AssertionError(f"warmup checkpoints: {os.listdir(crnn_dir)}")
    reloaded = CRNN(trainer.charmap.vocab_size,
                    lstm_hidden=LSTM_HIDDEN).to(dev)
    load_checkpoint(ckpts[0], reloaded)
    for k, v in trainer.model.state_dict().items():
        if not torch.equal(reloaded.state_dict()[k], v):
            raise AssertionError(f"the warmup checkpoint differs at {k}")
    del reloaded
    # one training batch as a step gives it to the CTC kernels: the trained
    # CRNN's train-mode log-probs and the OCR's labels of the noisy crops,
    # the upstream gradient that of the length-normalised batch mean
    cm = trainer.charmap
    words = collate_words([trainer.train_ds[i] for i in range(batch)], cm)
    noisy = trainer._noise(words.images)
    res = trainer.ocr.query(noisy)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (noisy, res.labels, res.lengths)]
    trainer.model.train()
    with torch.no_grad():
        lp = trainer.model(args[0]).float().contiguous()
    g = 1.0 / (batch * args[2].float().clamp(min=1.0))
    _, ctc_errs = hold_ctc(torch, lp, args[1].int().contiguous(),
                           args[2].int().contiguous(), g, cm.pad_id,
                           "the warmup's batch")
    log(f"[pipeline] warmup batch: CTC kernels vs plain at T={lp.shape[0]} "
        f"B={lp.shape[1]} V={lp.shape[2]} L={args[1].shape[1]} (the CRNN's "
        f"log-probs, the OCR's labels): {json.dumps(ctc_errs)}")
    # a warmup step alone after warm-up: the train step and its host read
    # of the loss, without the OCR
    step_ms = _host_ms(torch, lambda: float(trainer._train_step(*args)))
    _reset_counts()
    log(f"[pipeline] warmup: TrainCRNN.train {seconds:.2f} s for {epochs} "
        f"epochs of {steps} steps of {batch} crops with set-up, OCR and "
        f"checkpoints; one train step with its loss read {step_ms:.2f} ms "
        f"(host clock, median of 5, after warm-up; {card})")
    readings.update(warmup_s=seconds, warmup_step_ms=step_ms,
                    warmup_acc=records[-1]["CRNN_accuracy"],
                    warmup_ctc=ctc_errs)
    del trainer

    # (b) the CRNN evaluator on that checkpoint: word crops (decode only, no
    # kernel), then 8 documents in one batch (one strip gather)
    crnn_args = ["--device", "cuda", "--crnn_path", crnn_dir,
                 "--crnn_model_name", os.path.basename(ckpts[0]),
                 "--lstm_hidden", str(LSTM_HIDDEN), "--ocr", "Fake"]
    acc, cer = eval_crnn.main(crnn_args + ["--dataset", "synthetic_area"])
    add(_expect("eval_crnn synthetic_area", {}))
    acc_p, cer_p = eval_crnn.main(crnn_args + [
        "--dataset", "synthetic_patch", "--synthetic_docs", "8",
        "--batch_docs", "8", "--max_strips", str(S),
        "--doc_size", *map(str, DOC_SIZE)])
    add(_expect("eval_crnn synthetic_patch", {"gather_fwd": 1}))
    for v in (acc, cer, acc_p, cer_p):
        if not np.isfinite(v):
            raise AssertionError(f"eval_crnn: {acc, cer, acc_p, cer_p}")
    log(f"[pipeline] eval_crnn: word crops accuracy {acc:.4f} CER "
        f"{cer:.4f}; document strips accuracy {acc_p:.4f} CER {cer_p:.4f}")

    # (c) the UNet evaluator on the trainer phase's checkpoint, on the
    # channel-major conv: 16 documents in 2 batches of 8, each one UNet
    # forward (8 conv launches) and two gathers (original and cleaned)
    prep_args = ["--device", "cuda", "--prep_path", prep_ckpt,
                 "--dataset", "synthetic_patch", "--ocr", "Fake",
                 "--synthetic_docs", "16", "--batch_docs", str(D),
                 "--max_strips", str(S), "--synthetic_strips_per_doc", "12",
                 "--doc_size", *map(str, DOC_SIZE),
                 "--unet_features", str(UNET_FEATURES), "--show_orig"]
    with conv_impl_cmajor():
        (acc, cer), (o_acc, o_cer) = eval_prep.main(prep_args)
        add(_expect("eval_prep", {"conv": 2 * CONVS_PER_FORWARD,
                                  "gather_fwd": 2 * 2}))
        ev = EvalPrep(eval_prep.config_from_args(
            eval_prep.build_parser().parse_args(prep_args)))
    if not all(0.0 <= v <= 1.0 + 1e-6 for v in (acc, o_acc)) \
            or not all(np.isfinite(v) for v in (cer, o_cer)):
        raise AssertionError(f"eval_prep: {acc, cer, o_acc, o_cer}")
    log(f"[pipeline] eval_prep (conv kernel): cleaned strips accuracy "
        f"{acc:.4f} CER {cer:.4f}; original strips accuracy {o_acc:.4f} CER "
        f"{o_cer:.4f} (the trainer phase's 2-epoch UNet, random CRNN)")
    # an eval batch after warm-up: the whole evaluation of 2 batches (the
    # UNet, the gathers and the OCR of 2 x 96 strips x 2), and the UNet
    # forward with the cleaned strips' gather alone
    batch_ms = _host_ms(torch, ev.eval, iters=3) / 2
    docs = collate_docs(ev.dataset.samples[:D])
    images, bboxes = (torch.from_numpy(docs.images).to(dev),
                      torch.from_numpy(docs.bboxes).to(dev))
    forward_ms = _host_ms(torch, lambda: ev._prep_strips(images, bboxes))
    _reset_counts()
    log(f"[pipeline] eval_prep: one batch of {D} documents {batch_ms:.2f} ms "
        f"with its OCR, the UNet forward and strip gather alone "
        f"{forward_ms:.2f} ms (host clock, medians, after warm-up; {card})")
    readings.update(eval_batch_ms=batch_ms, eval_forward_ms=forward_ms,
                    cleaned=(acc, cer), original=(o_acc, o_cer))

    # (d) the CER seed of 4 documents, one gather each (D=1). The OCR's
    # inputs, the strips `get_text_stack` cut on the card, are recorded and
    # held bitwise against the plain gather on the same documents and boxes
    cm = CharMap.default()
    ds = PatchDocuments.synthetic(4, seed=7, n_strips=12, max_strips=S,
                                  doc_size=DOC_SIZE)
    engine = OcrQueryEngine(get_ocr_helper("Fake"), cm)
    strips, texts = [], []
    query = engine.query

    def recorded(images):
        strips.append(np.array(images))
        res = query(images)
        texts.append(res.texts)
        return res
    engine.query = recorded
    cers = seed_patch(ds, engine, cm, device="cuda")
    add(_expect("cer_seed", {"gather_fwd": len(ds)}))
    if len(strips) != len(ds):
        raise AssertionError(f"cer_seed queried the OCR {len(strips)} times")
    for sample, got in zip(ds.samples, strips):
        rows = np.nonzero(sample.strip_mask)[0]
        doc = torch.from_numpy(sample.image).to(dev)
        want = gather_cuda.text_stack_plain(
            doc.reshape(1, 1, *doc.shape[-2:]),
            torch.from_numpy(sample.bboxes[rows]).to(dev)[None])[0, :, None]
        if got.shape != tuple(want.shape) \
                or not np.array_equal(got, want.cpu().numpy()):
            raise AssertionError(
                f"cer_seed strips {got.shape} differ from the plain gather "
                f"{tuple(want.shape)}: max abs err "
                f"{np.abs(got - want.cpu().numpy()).max()}")
    # on the host: each CER against an edit distance of the OCR's text and
    # the ground truth recomputed here (seed_patch's bookkeeping, not the
    # gather, which the check above holds)
    for sample, read in zip(ds.samples, texts):
        rows = np.nonzero(sample.strip_mask)[0]
        gts = cm.decode(sample.gt_labels[rows], sample.gt_lengths[rows])
        for r, gt, got in zip(rows, gts, read):
            gt_c = cm.clean(gt)
            want = _edit_distance(cm.clean(got), gt_c) / max(1, len(gt_c))
            if abs(cers[sample.strip_names[r]] - want) > 1e-12:
                raise AssertionError(f"CER seed of {sample.strip_names[r]}: "
                                     f"{cers[sample.strip_names[r]]} vs "
                                     f"{want}")
    if len(cers) != sum(int(s.strip_mask.sum()) for s in ds.samples):
        raise AssertionError(f"{len(cers)} CER seeds")
    log(f"[pipeline] cer_seed: {len(cers)} strips of {len(ds)} documents, "
        f"{strips[0].shape} a document, bitwise equal to the plain gather; "
        f"mean CER {np.mean(list(cers.values())):.4f}; native host library "
        f"loaded: {native.have_native()}")
    readings["have_native"] = native.have_native()
    return total, readings, ckpts[0]


def run_area(torch, dev, card, exp, crnn_ckpt):
    """The area (word-crop) trainer through `cli/area_cli.py` at full width
    on the card, from the pipeline phase's warmup checkpoint, writing under
    `exp`; then both CTC kernels against their plain versions at phase A's
    history shape and phase B's, and an area step timed. Returns the kernel
    launch counts of the training run, its readings and the CTC errors."""
    import glob

    from qea_ocr_tpu_torch.cli import area_cli
    from qea_ocr_tpu_torch.data import collate_words
    from qea_ocr_tpu_torch.models.unet import UNet
    from qea_ocr_tpu_torch.tracking import decaying_weights
    from qea_ocr_tpu_torch.utils.io import load_checkpoint

    B, W, prop = AREA_BATCH, AREA_WINDOW, 0.5
    argv = ["--device", "cuda", "--ocr", "Fake", "--dataset", "synthetic",
            "--batch_size", str(B), "--synthetic_train_size",
            str(AREA_TRAIN), "--synthetic_val_size", str(AREA_VAL),
            "--epoch", str(AREA_EPOCHS), "--minibatch_subset", "topKCER",
            "--minibatch_subset_prop", str(prop), "--inner_limit", "2",
            "--inner_limit_skip", "--window_size", str(W),
            "--lr_scheduler", "cosine", "--lr_scheduler_prep", "cosine",
            "--prep_ema", "0.99", "--prep_pretrain_epochs", "1",
            "--crnn_model", crnn_ckpt, "--unet_features", str(UNET_FEATURES),
            "--lstm_hidden", str(LSTM_HIDDEN), "--exp_base_path", exp]
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = area_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    steps, val_batches = AREA_TRAIN // B, -(-AREA_VAL // B)
    want = {k: 0 for k in counts}
    want.update(ctc_fwd=AREA_EPOCHS * (3 * steps + val_batches),
                ctc_bwd=AREA_EPOCHS * 3 * steps)
    log(f"[area] kernel launches in this phase: {json.dumps(counts)}")
    if counts != want:
        raise AssertionError(f"launches in the area phase {counts}, "
                             f"expected {want}")

    # the ledger: ceil(64 * 0.5) = 32 crops a step queried once clean and
    # once jittered; validation reads every crop; the logged counters are
    # the training queries only
    train_calls = steps * 2 * int(np.ceil(B * (1 - prop)))
    if trainer.ocr.total_calls != AREA_EPOCHS * (train_calls + AREA_VAL) \
            or trainer.ocr.count_calls != trainer.ocr.total_calls:
        raise AssertionError(f"area query ledger {trainer.ocr.total_calls}, "
                             f"expected {AREA_EPOCHS * (train_calls + AREA_VAL)}")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != AREA_EPOCHS:
        raise AssertionError(f"{len(recs)} area epochs logged")
    for i, rec in enumerate(recs):
        if rec["Black-Box Calls"] != train_calls \
                or rec["Total Black-Box Calls"] != (i + 1) * train_calls:
            raise AssertionError(f"area query ledger of epoch {i}: {rec}")
        if not all(np.isfinite(rec[k]) for k in (
                "train_loss", "val_loss", "CRNN_loss", "CRNN_CER",
                "Fake_cer")):
            raise AssertionError(f"non-finite losses in area epoch {i}: "
                                 f"{rec}")
        log(f"[area] epoch {rec['Epoch']}: train_loss "
            f"{rec['train_loss']:.4f}, val_loss {rec['val_loss']:.4f}, "
            f"CRNN_loss {rec['CRNN_loss']:.4f}, cleaned-crop OCR accuracy "
            f"{rec['Fake_accuracy']:.4f} CER {rec['Fake_cer']:.4f}, queries "
            f"{rec['Black-Box Calls']} + {AREA_VAL}")
    for name in ("tracked_labels/tracked_labels_current.json",
                 "selected_samples/selected_samples_current.json",
                 "cers/all_cers.json", f"img_out/out_{AREA_EPOCHS - 1}.png",
                 f"ckpts/CRNN_model_{AREA_EPOCHS - 1}", "params.txt"):
        if not os.path.exists(os.path.join(exp, name)):
            raise AssertionError(f"the area trainer did not write {name}")
    # Prep_model_best is written when an epoch's OCR accuracy beats 0 (as
    # in the JAX trainer)
    best = os.path.exists(os.path.join(exp, "ckpts", "Prep_model_best"))
    if best != (max(r["Fake_accuracy"] for r in recs) > 0):
        raise AssertionError(f"Prep_model_best written: {best}, accuracies "
                             f"{[r['Fake_accuracy'] for r in recs]}")
    # the last epoch's UNet checkpoint reloads strictly and holds the EMA
    # parameters, not the raw ones
    ckpt = [p for p in glob.glob(os.path.join(
        exp, "ckpts", f"Prep_model_{AREA_EPOCHS - 1}_*"))
        if not p.endswith(".optim")]
    if len(ckpt) != 1:
        raise AssertionError(f"area checkpoints: {ckpt}")
    reloaded = UNet(init_features=UNET_FEATURES, conv_impl="xla")
    load_checkpoint(ckpt[0], reloaded)
    for got, ema, raw in zip(reloaded.parameters(), trainer.ema_params,
                             trainer.prep_model.parameters()):
        if not torch.equal(got, ema.cpu()):
            raise AssertionError("the area checkpoint is not the EMA")
    if all(torch.equal(e, r) for e, r in zip(
            trainer.ema_params, trainer.prep_model.parameters())):
        raise AssertionError("the EMA equals the raw parameters")
    log(f"[area] area_cli.main: {AREA_EPOCHS} epochs with a pretraining "
        f"epoch, set-up, OCR and checkpoints in {seconds:.2f} s; "
        f"Prep_model_best written: {best}; {card}")
    area_run = dict(argv=argv, records=recs, train_calls=train_calls)

    # one training batch as the steps see it: the cleaned crops, the
    # history labels the OCR gave them (phase A, B*W rows) and the ground
    # truth (phase B, B rows); the trained CRNN's log-probs, frozen batch
    # statistics as in both phases
    cm = trainer.charmap
    words = collate_words([trainer.train_ds[i] for i in range(B)], cm)
    images = torch.from_numpy(words.images).to(dev)
    crops = trainer.steps.prep_forward(images)
    labs, lens, valid = trainer.history.gather(words.strip_ids)
    if not valid[:, 0].any():
        raise AssertionError("no history labels for the batch")
    L = cm.max_len
    trainer.crnn_model.eval()
    with torch.no_grad():
        lp = trainer.crnn_model(crops).float().contiguous()
    errs = {}
    for where, scores, lab, ln in (
            ("phase A's history", lp.repeat_interleave(W, dim=1),
             labs.reshape(B * W, L), lens.reshape(B * W)),
            ("phase B's ground truth", lp, words.labels, words.lengths)):
        lab_t = torch.from_numpy(np.ascontiguousarray(lab)).to(dev).int()
        len_t = torch.from_numpy(np.ascontiguousarray(ln)).to(dev).int()
        g = 1.0 / (scores.shape[1] * len_t.float().clamp(min=1.0))
        _, e = hold_ctc(torch, scores.contiguous(), lab_t.contiguous(),
                        len_t.contiguous(), g, cm.pad_id, f"the area's {where}")
        errs[where] = e
        log(f"[area] {where}: CTC kernels vs plain at T={scores.shape[0]} "
            f"B={scores.shape[1]} V={scores.shape[2]} L={L}: "
            f"{json.dumps(e)}")

    # an area step alone after warm-up, without the OCR: phase A (history
    # CTC over B*W rows and one jitter copy) and phase B, both losses read
    bb_mask = np.zeros((B,), bool)
    bb_mask[: B // 2] = True
    hv = valid & bb_mask[:, None]
    jitter = torch.from_numpy(trainer._noise(crops.cpu().numpy())[None]).to(dev)
    a_args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        bb_mask, labs, lens, hv)]
    b_args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        words.labels, words.lengths, words.strip_ids)]

    def step():
        float(trainer._patch_steps.phase_a(
            crops, *a_args, decaying_weights(0.7, W, dev), jitter,
            a_args[1][None, :, 0], a_args[2][None, :, 0], decaying=True,
            inner_limit_skip=True))
        float(trainer.steps.phase_b(
            images, b_args[0], trainer.cer_table, trainer.ent_table,
            b_args[1], b_args[2], update_crnn=False)[1]["loss"])
    step_ms = _host_ms(torch, step)
    _reset_counts()
    log(f"[area] one area step (phase A on {B} crops x {W} history depths "
        f"+ 1 jitter copy, phase B on {B}) with both losses read "
        f"{step_ms:.2f} ms (host clock, median of 5, after warm-up; {card})")
    return counts, dict(seconds=seconds, step_ms=step_ms,
                        ledger=trainer.ocr.total_calls, best_written=best,
                        fake_accuracy=[r["Fake_accuracy"] for r in recs]), \
        errs, area_run


def _with_flag(argv: list, exp: str, *flags: str) -> list:
    """`argv` with its `--exp_base_path` replaced by `exp` and `flags`
    added."""
    out = list(argv)
    out[out.index("--exp_base_path") + 1] = exp
    return out + list(flags)


def _ledger(rec: dict) -> tuple:
    return tuple(rec[k] for k in LEDGER_KEYS if k in rec)


def run_parallel(torch, dev, card, work, single, area_run):
    """The parallel layer on one card: a process group of one made by the
    CLI from the `QEA_*` variables (NCCL on cuda:0), the patch trainer with
    `--data_parallel` and with `--tensor_parallel 1` on the trainer phase's
    configuration (`single`: its argv, records and step losses), the warmup
    and the area trainer with `--data_parallel` for an epoch, and
    data-parallel serving against single-process serving. Returns the
    kernel launch counts of the whole phase and its readings."""
    import glob

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from qea_ocr_tpu_torch.cli import area_cli, patch_cli, train_crnn
    from qea_ocr_tpu_torch.data import PatchDocuments, collate_docs
    from qea_ocr_tpu_torch.models.unet import UNet
    from qea_ocr_tpu_torch.parallel import multihost
    from qea_ocr_tpu_torch.serve.cleaner import DocumentCleaner
    from qea_ocr_tpu_torch.utils.io import load_checkpoint

    t_phase = time.perf_counter()
    os.environ.update(QEA_DISTRIBUTED="1", QEA_NUM_PROCESSES="1",
                      QEA_PROCESS_ID="0",
                      QEA_COORDINATOR=f"127.0.0.1:{_free_port()}")
    # the CLI makes the group; time that call where it happens
    init = multihost.maybe_init_distributed
    setup = {}

    def timed_init(device):
        t0 = time.perf_counter()
        made = not dist.is_initialized()
        out = init(device)
        if made:
            torch.cuda.synchronize()
            setup["s"] = time.perf_counter() - t0
        return out

    multihost.maybe_init_distributed = timed_init
    readings = {}
    _reset_counts()
    try:
        # (a) the patch trainer, data parallel, against the trainer phase
        with conv_impl_cmajor():
            exp_dp = os.path.join(work, "trainer_dp")
            t0 = time.perf_counter()
            dp = patch_cli.main(_with_flag(single["argv"], exp_dp,
                                           "--data_parallel"))
            torch.cuda.synchronize()
            dp_s = time.perf_counter() - t0
        if not (dist.is_initialized() and dist.get_backend() == "nccl"
                and dist.get_world_size() == 1
                and torch.cuda.current_device() == 0
                and dp.device == torch.device("cuda", 0)):
            raise AssertionError("the parallel phase is not on an NCCL group "
                                 "of one on cuda:0")
        if dp.group is None or dp._world != 1:
            raise AssertionError("the data-parallel trainer has no group")
        with open(os.path.join(exp_dp, "metrics.jsonl")) as f:
            dp_recs = [json.loads(line) for line in f]
        if [_ledger(r) for r in dp_recs] != \
                [_ledger(r) for r in single["records"]]:
            raise AssertionError(f"data-parallel ledger {dp_recs} differs "
                                 f"from {single['records']}")
        first = [abs(a - b) / abs(b) for a, b in zip(
            dp.step_losses[0], single["step_losses"][0])]
        if max(first) > PARALLEL_FIRST_RTOL:
            raise AssertionError(f"first step losses {dp.step_losses[0]} vs "
                                 f"{single['step_losses'][0]}")
        epoch_rel = max(abs(a[k] - b[k]) / abs(b[k])
                        for a, b in zip(dp_recs, single["records"])
                        for k in EPOCH_LOSS_KEYS)
        if epoch_rel > PARALLEL_EPOCH_RTOL:
            raise AssertionError(f"epoch losses differ by {epoch_rel} "
                                 f"(relative)")
        step_keys = ("time/prep_extract_mean_s", "time/phase_ab_mean_s")
        step_dp = sum(dp_recs[-1][k] for k in step_keys)
        step_sp = sum(single["records"][-1][k] for k in step_keys)
        log(f"[parallel] patch trainer --data_parallel (NCCL, world 1): "
            f"ledger equal to the trainer phase's; first step losses "
            f"(phase B, phase A) {dp.step_losses[0]} vs "
            f"{single['step_losses'][0]}, largest relative difference "
            f"{max(first):.3g}; epoch losses (train, val, CRNN) at most "
            f"{epoch_rel:.3g} apart (relative); a step (prep_extract + "
            f"phase_ab, host clock, mean over both epochs) "
            f"{1e3 * step_dp:.2f} ms vs {1e3 * step_sp:.2f} ms single-process;"
            f" patch_cli.main {dp_s:.2f} s vs {single['seconds']:.2f} s "
            f"({card})")
        readings.update(nccl_setup_s=setup.get("s"), dp_step_ms=1e3 * step_dp,
                        sp_step_ms=1e3 * step_sp, first_step_rel=max(first),
                        epoch_loss_rel=epoch_rel, dp_trainer_s=dp_s)
        del dp

        # (b) the same with the parameters stored sharded over a model axis
        # of one (FSDP2): the twin still reaches the conv kernel
        counts_before = _counts()
        with conv_impl_cmajor():
            exp_tp = os.path.join(work, "trainer_tp")
            tp = patch_cli.main(_with_flag(single["argv"], exp_tp,
                                           "--tensor_parallel", "1"))
            torch.cuda.synchronize()
        tp_counts = {k: v - counts_before[k] for k, v in _counts().items()}
        if tp_counts != trainer_launches():
            raise AssertionError(f"tensor-parallel launches {tp_counts}, "
                                 f"expected {trainer_launches()}")
        if not all(isinstance(p, DTensor)
                   for p in tp.crnn_model.lstm.parameters()):
            raise AssertionError("the tensor-parallel CRNN's LSTM is not "
                                 "stored as DTensors")
        n_dtensor = sum(isinstance(p, DTensor)
                        for m in (tp.prep_model, tp.crnn_model)
                        for p in m.parameters())
        with open(os.path.join(exp_tp, "metrics.jsonl")) as f:
            tp_recs = [json.loads(line) for line in f]
        if [_ledger(r) for r in tp_recs] != \
                [_ledger(r) for r in single["records"]]:
            raise AssertionError(f"tensor-parallel ledger {tp_recs}")
        del tp

        def last_prep(exp):
            return [p for p in glob.glob(os.path.join(
                exp, "ckpts", f"Prep_model_{TRAINER_EPOCHS - 1}_*"))
                if not p.endswith(".optim")][0]

        docs = torch.from_numpy(collate_docs(list(PatchDocuments.synthetic(
            D, seed=61, n_strips=12, max_strips=S, doc_size=DOC_SIZE))).images
        ).to(dev)
        outs = []
        for exp in (exp_tp, exp_dp):
            plain = UNet(init_features=UNET_FEATURES, conv_impl="xla")
            load_checkpoint(last_prep(exp), plain)
            with torch.no_grad():
                outs.append(plain.to(dev).eval()(docs))
        tp_diff = float((outs[0] - outs[1]).abs().max())
        if not (torch.isfinite(outs[0]).all() and tp_diff <= PARALLEL_DOC_ATOL):
            raise AssertionError(f"the tensor-parallel checkpoint's forward "
                                 f"differs from the data-parallel one's by "
                                 f"{tp_diff}")
        step_tp = sum(tp_recs[-1][k] for k in step_keys)
        log(f"[parallel] patch trainer --tensor_parallel 1 (FSDP2 on a 1x1 "
            f"mesh): {n_dtensor} parameters stored as DTensors, launches "
            f"{json.dumps(tp_counts)} (8 conv a twin forward), ledger equal;"
            f" a step {1e3 * step_tp:.2f} ms (host clock, as above); its "
            f"last checkpoint in a plain UNet against the data-parallel "
            f"run's, eval forward on {D} documents: max abs difference "
            f"{tp_diff:.3g}")
        readings.update(tp_dtensors=n_dtensor, tp_checkpoint_diff=tp_diff,
                        tp_step_ms=1e3 * step_tp)

        # (c) the warmup and the area trainer, data parallel, one epoch each
        n_train, n_val, batch = 256, 64, 64
        warm = train_crnn.main([
            "--device", "cuda", "--dataset", "synthetic", "--ocr", "Fake",
            "--lstm_hidden", str(LSTM_HIDDEN), "--batch_size", str(batch),
            "--synthetic_train_size", str(n_train),
            "--synthetic_val_size", str(n_val), "--epoch", "1", "--std", "3",
            "--crnn_model_path", os.path.join(work, "crnn_dp", "model"),
            "--data_parallel"])
        if warm.group is None or warm.ocr.total_calls != n_train + n_val:
            raise AssertionError(f"data-parallel warmup ledger "
                                 f"{warm.ocr.total_calls}, expected "
                                 f"{n_train + n_val}")
        del warm
        exp_area = os.path.join(work, "area_dp")
        argv = _with_flag(area_run["argv"], exp_area, "--data_parallel")
        argv[argv.index("--epoch") + 1] = "1"
        area = area_cli.main(argv)
        with open(os.path.join(exp_area, "metrics.jsonl")) as f:
            area_rec = json.loads(f.readline())
        if area.group is None \
                or area.ocr.total_calls != area_run["train_calls"] + AREA_VAL \
                or _ledger(area_rec) != _ledger(area_run["records"][0]):
            raise AssertionError(f"data-parallel area ledger "
                                 f"{area.ocr.total_calls}, {area_rec}")
        del area
        log(f"[parallel] warmup and area trainers --data_parallel, one epoch "
            f"each: ledgers {n_train + n_val} and "
            f"{area_run['train_calls'] + AREA_VAL} as single-process")

        # (d) serving: 16 documents, data parallel against single-process
        sd = {k: v.cpu() for k, v in torch.load(
            last_prep(exp_dp), map_location="cpu", weights_only=True).items()}
        pages = list(collate_docs(list(PatchDocuments.synthetic(
            2 * D, seed=62, n_strips=4, max_strips=S, doc_size=DOC_SIZE)
        )).images[:, 0])
        cleaned = [DocumentCleaner(
            state_dict=sd, device="cuda", batch_size=D, doc_size=DOC_SIZE,
            unet_features=UNET_FEATURES, data_parallel=flag
        ).clean_arrays_uint8(pages) for flag in (True, False)]
        if len(cleaned[0]) != 2 * D or not all(
                np.array_equal(a, b) for a, b in zip(*cleaned)):
            raise AssertionError("data-parallel serving differs from "
                                 "single-process serving")
        log(f"[parallel] DocumentCleaner(data_parallel=True) on {2 * D} "
            f"documents: bitwise equal to single-process")
        counts = _counts()
    finally:
        multihost.maybe_init_distributed = init
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in ("QEA_DISTRIBUTED", "QEA_NUM_PROCESSES", "QEA_PROCESS_ID",
                  "QEA_COORDINATOR"):
            os.environ.pop(k, None)
    phase_s = time.perf_counter() - t_phase
    log(f"[parallel] kernel launches in this phase: {json.dumps(counts)}")
    for k, v in counts.items():
        if v < 1:
            raise AssertionError(f"{k} never launched in the parallel phase")
    log(f"[parallel] phase wall time {phase_s:.2f} s, NCCL group set-up "
        f"{setup.get('s', float('nan')):.3f} s; two or more ranks share no "
        f"card here: the 2- and 4-rank checks are the CPU (Gloo) tests; "
        f"{card}")
    readings["phase_s"] = phase_s
    _reset_counts()
    return counts, readings


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_EXPORT_LOADER = """
import sys, time
import numpy as np
import torch
try:
    import qea_ocr_tpu_torch
except ImportError:
    pass
else:
    sys.exit("the port is importable here")
t0 = time.perf_counter()
torch.zeros(1, device="cuda")
cuda_s = time.perf_counter() - t0
t0 = time.perf_counter()
clean = torch.export.load(sys.argv[1]).module()
load_s = time.perf_counter() - t0
x = torch.from_numpy(np.load(sys.argv[2])).cuda()
times = []
with torch.no_grad():
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = clean(x)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
np.save(sys.argv[3], y.cpu().numpy())
print(cuda_s, load_s, float(np.median(times[1:])))
"""


# a cmajor artifact's loader: the repository root on sys.path and only the
# operator's registration module imported, nothing of the models, trainers
# or serving
_CMAJOR_LOADER = """
import sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import qea_ocr_tpu_torch.ops.conv_cmajor
from qea_ocr_tpu_torch.ops.cuda import conv_cmajor_cuda


def check_modules():
    bad = sorted(m for m in sys.modules if m.startswith(tuple(
        f"qea_ocr_tpu_torch.{p}" for p in ("models", "train", "serve"))))
    if bad:
        sys.exit(f"the loader imported {bad}")


check_modules()
t0 = time.perf_counter()
torch.zeros(1, device="cuda")
cuda_s = time.perf_counter() - t0
t0 = time.perf_counter()
clean = torch.export.load(sys.argv[2]).module()
load_s = time.perf_counter() - t0
x = torch.from_numpy(np.load(sys.argv[3])).cuda()
times = []
with torch.no_grad():
    conv_cmajor_cuda.launches = 0
    y = clean(x)
    torch.cuda.synchronize()
    launches = conv_cmajor_cuda.launches
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clean(x)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
check_modules()
np.save(sys.argv[4], y.float().cpu().numpy())
print(cuda_s, load_s, float(np.median(times[1:])), launches)
"""


def run_export(torch, dev, card, work, prep_ckpt):
    """The trainer phase's last UNet checkpoint through
    `tools/export_model.py` on the card, on the library route and on the
    channel-major one. The library artifact is loaded and run by a Python
    process that cannot import the port, against the eager eval forward;
    the channel-major one by a process that imports only the conv
    operator's module, against the eager twin. Returns the phase's readings
    and the loader's conv launches for one forward."""
    from qea_ocr_tpu_torch.data import PatchDocuments, collate_docs
    from qea_ocr_tpu_torch.models.unet import UNet
    from qea_ocr_tpu_torch.tools import export_model
    from qea_ocr_tpu_torch.utils.io import load_checkpoint

    root = os.path.dirname(os.path.abspath(__file__))
    flags = ["--prep_path", prep_ckpt, "--batch_size", str(D), "--doc_size",
             *map(str, DOC_SIZE), "--unet_features", str(UNET_FEATURES),
             "--device", "cuda"]
    x = collate_docs(list(PatchDocuments.synthetic(
        D, seed=61, n_strips=12, max_strips=S, doc_size=DOC_SIZE))).images
    np.save(os.path.join(work, "x.npy"), x)
    eager = UNet(init_features=UNET_FEATURES, conv_impl="xla")
    load_checkpoint(prep_ckpt, eager)
    eager = eager.to(dev).eval()
    twin = eager.twin("cmajor").eval()
    xs = torch.from_numpy(x).to(dev)
    readings = {}
    for route in ("xla", "cmajor"):
        out = os.path.join(work, f"prep_{route}.pt2")
        _reset_counts()
        with contextlib.ExitStack() as stack:
            if route == "cmajor":
                stack.enter_context(conv_impl_cmajor())
            t0 = time.perf_counter()
            info = export_model.main(flags + ["--out", out])
            export_s = time.perf_counter() - t0
        if _counts() != {k: 0 for k in _counts()}:
            raise AssertionError(f"the {route} export launched {_counts()}")
        want_nodes = CONVS_PER_FORWARD if route == "cmajor" else 0
        if info["conv_impl"] != route \
                or info["conv_flat_nodes"] != want_nodes:
            raise AssertionError(f"the {route} export: {info}")
        if route == "xla":
            # -I: neither PYTHONPATH nor the current directory on sys.path,
            # and the process runs outside the checkout
            cmd = [sys.executable, "-I", "-c", _EXPORT_LOADER, out, "x.npy",
                   "y.npy"]
            model = eager
        else:
            cmd = [sys.executable, "-I", "-c", _CMAJOR_LOADER, root, out,
                   "x.npy", "y.npy"]
            model = twin
        proc = subprocess.run(cmd, cwd=work, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"loading the {route} artifact failed: "
                                 f"{proc.stdout}{proc.stderr}")
        vals = proc.stdout.split()
        cuda_s, load_s, artifact_ms = map(float, vals[:3])
        got = np.load(os.path.join(work, "y.npy"))
        _reset_counts()
        with torch.no_grad():
            want = model(xs).float().cpu().numpy()
            forward_launches = _counts()["conv"]
            eager_ms = _host_ms(torch, lambda: model(xs))
        _reset_counts()
        diff = np.abs(got - want)
        if got.shape != want.shape or not np.isfinite(got).all() \
                or diff.max() > EXPORT_MAX_ERR \
                or diff.mean() > EXPORT_MEAN_ERR:
            raise AssertionError(f"{route} artifact vs eager: shape "
                                 f"{got.shape}, max {diff.max()}, mean "
                                 f"{diff.mean()}")
        r = dict(bytes=info["bytes"], export_s=export_s, cuda_s=cuda_s,
                 load_s=load_s, artifact_ms=artifact_ms, eager_ms=eager_ms,
                 max_abs=float(diff.max()), mean_abs=float(diff.mean()),
                 nodes=info["conv_flat_nodes"])
        if route == "cmajor":
            r["loader_conv_launches"] = int(vals[3])
            r["fused"] = info["cmajor_fused"]
            if r["loader_conv_launches"] != CONVS_PER_FORWARD \
                    or forward_launches != CONVS_PER_FORWARD:
                raise AssertionError(
                    f"conv launches a forward: artifact "
                    f"{r['loader_conv_launches']}, eager twin "
                    f"{forward_launches}, expected {CONVS_PER_FORWARD}")
        readings[route] = r
        log(f"[export] {route}: {json.dumps(info)}: export {export_s:.2f} "
            f"s; in a process "
            + ("without the port" if route == "xla" else
               "that imports only qea_ocr_tpu_torch.ops.conv_cmajor")
            + f", CUDA set-up {cuda_s:.2f} s, then the artifact's load "
            f"{load_s:.2f} s; artifact vs eager "
            f"{'eval forward' if route == 'xla' else 'twin forward'} (D={D}, "
            f"{DOC_SIZE}, bf16) max abs {diff.max():.3g}, mean "
            f"{diff.mean():.3g}; a forward {artifact_ms:.2f} ms (artifact) "
            f"/ {eager_ms:.2f} ms (eager) (host clock, medians after "
            f"warm-up; {card})")
    return readings, readings["cmajor"]["loader_conv_launches"]


def _random_search_params(n: int, space) -> list:
    """The parameters a seed-0 random search draws for `n` trials, each
    suggestion of `space` (name, low, high, log) in turn, computed here."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        trial = {}
        for name, lo, hi, log_scale in space:
            if log_scale is None:
                trial[name] = int(rng.integers(lo, hi + 1))
            elif log_scale:
                trial[name] = float(np.exp(rng.uniform(np.log(lo),
                                                       np.log(hi))))
            else:
                trial[name] = float(rng.uniform(lo, hi))
        out.append(trial)
    return out


def run_tooling(torch, dev, card, work, single):
    """Pruning and sweeps at full width on the card, on the trainer phase's
    world: the CER seed, both pruning methods, the CER analysis, one pruned
    epoch of `patch_cli.main` on the conv kernel's route, and the random
    search over both trainers. Returns the kernel launch counts of the
    whole phase and its readings."""
    from qea_ocr_tpu_torch.cli import patch_cli
    from qea_ocr_tpu_torch.data import collate_docs
    from qea_ocr_tpu_torch.ops.text_stack import get_text_stack_batch
    from qea_ocr_tpu_torch.pruning.prune import doc_mean_cers, load_artifact
    from qea_ocr_tpu_torch.sweeps import sweep
    from qea_ocr_tpu_torch.tools import (
        build_patch_dataset, cer_analysis, cer_seed, prune_cli)

    t_phase = time.perf_counter()
    total, readings = {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # (1) the CER seed of the trainer's 16 training documents: one gather
    # a document
    cers_path = os.path.join(work, "tooling_cers.json")
    _reset_counts()
    t0 = time.perf_counter()
    cer_seed.main(["--mode", "patch", "--dataset", "synthetic", "--ocr",
                   "Fake", "--synthetic_size", str(TOOLING_TRAIN), "--seed",
                   str(TOOLING_SEED), "--strips_per_doc", str(TOOLING_STRIPS),
                   "--max_strips", str(S), "--doc_size", *map(str, DOC_SIZE),
                   "--device", "cuda", "--out", cers_path])
    readings["cer_seed_s"] = time.perf_counter() - t0
    add(_expect("cer_seed", {"gather_fwd": TOOLING_TRAIN}, "tooling"))
    with open(cers_path) as f:
        strip_cers = json.load(f)
    means = doc_mean_cers(strip_cers)
    if len(strip_cers) != TOOLING_TRAIN * TOOLING_STRIPS \
            or len(means) != TOOLING_TRAIN:
        raise AssertionError(f"CER seed: {len(strip_cers)} strips of "
                             f"{len(means)} documents")

    # (2) both pruning methods to half the documents
    arts = {}
    for method in ("topk", "FL"):
        prune_cli.main(["--cers", cers_path, "--method", method,
                        "--num_samples", str(TOOLING_KEEP), "--out_dir",
                        work, "--artifact_name", f"tooling_{method}"])
        arts[method] = load_artifact(
            os.path.join(work, f"tooling_{method}.json"))
        if len(arts[method]) != TOOLING_KEEP or not all(
                means[k] == v for k, v in arts[method].items()):
            raise AssertionError(f"{method} artifact: {arts[method]}")
    ranked = sorted(means.values(), reverse=True)
    if sorted(arts["topk"].values(), reverse=True) != ranked[:TOOLING_KEEP]:
        raise AssertionError("the topk artifact is not the highest CERs")
    log(f"[tooling] CER seed of {TOOLING_TRAIN} documents in "
        f"{readings['cer_seed_s']:.2f} s; kept by topk "
        f"{sorted(arts['topk'])}, by FL {sorted(arts['FL'])}")

    # (3) the CER analysis of the same JSON
    summary_path = os.path.join(work, "tooling_summary.json")
    cer_analysis.main(["--cers", cers_path, "--summary_out", summary_path])
    with open(summary_path) as f:
        summary = json.load(f)
    if summary["count"] != TOOLING_TRAIN \
            or summary["easy_docs"] + summary["hard_docs"] != TOOLING_TRAIN \
            or sum(summary["histogram"]) != TOOLING_TRAIN:
        raise AssertionError(f"CER analysis: {summary}")
    add(_expect("prune_cli + cer_analysis", {}, "tooling"))

    # (4) one epoch of the trainer on the topk artifact, the no-grad
    # forwards on the conv kernel: 8 documents, one step and one
    # validation batch
    exp = os.path.join(work, "tooling_trainer")
    topk_path = os.path.join(work, "tooling_topk.json")
    argv = _with_flag(single["argv"], exp, "--epoch", "1",
                      "--pruning_artifact", topk_path)
    with conv_impl_cmajor():
        t0 = time.perf_counter()
        trainer = patch_cli.main(argv)
        torch.cuda.synchronize()
        readings["pruned_s"] = time.perf_counter() - t0
    steps = TOOLING_KEEP // D
    add(_expect("the pruned epoch",
                trainer_launches(steps, TOOLING_VAL // D, 1), "tooling"))
    # the synthetic documents are `synth/doc_{index:05d}`, grouped by
    # `doc_mean_cers` as `doc_{index:05d}`
    want_idx = sorted(int(k.rsplit("_", 1)[1]) for k in arts["topk"])
    if sorted(trainer.train_indices.tolist()) != want_idx \
            or trainer.train_set_size != TOOLING_KEEP:
        raise AssertionError(f"trained on {trainer.train_indices}, the "
                             f"artifact holds {want_idx}")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rec = json.loads(f.readline())
    train_calls = TOOLING_KEEP * int(np.ceil(TOOLING_STRIPS * 0.5)) * 2
    if rec["Black-Box Calls"] != train_calls or rec["Train + Val BB Calls"] \
            != train_calls + TOOLING_VAL * TOOLING_STRIPS:
        raise AssertionError(f"pruned epoch's query ledger: {rec}")
    readings["pruned_epoch_s"] = rec["time/epoch_s"]
    # the CTC pair at one batch of this run: phase B's shape, the cleaned
    # strips of the pruned documents through the trained CRNN, their labels
    batch = collate_docs([trainer.dataset[int(i)]
                          for i in trainer.train_indices[:D]])
    cm = trainer.charmap
    trainer.prep_eval_model.eval()
    trainer.crnn_model.eval()
    with torch.no_grad():
        cleaned = trainer.prep_eval_model(
            torch.from_numpy(batch.images).to(dev)).float()
        strips = get_text_stack_batch(
            cleaned, torch.from_numpy(batch.bboxes).to(dev))
        lp = trainer.crnn_model(strips.reshape(D * S, *strips.shape[2:]))
        lp = lp.float().contiguous()
    labels = torch.from_numpy(batch.gt_labels.reshape(D * S, -1)).to(dev)
    lengths = torch.from_numpy(batch.gt_lengths.reshape(D * S)).to(dev)
    g = 1.0 / (D * S * lengths.float().clamp(min=1.0))
    _, ctc_errs = hold_ctc(torch, lp, labels.int().contiguous(),
                           lengths.int().contiguous(), g, cm.pad_id,
                           "the pruned run's batch")
    _reset_counts()
    readings["ctc"] = ctc_errs
    log(f"[tooling] pruned epoch: patch_cli.main in "
        f"{readings['pruned_s']:.2f} s with set-up and checkpoints, the "
        f"epoch {rec['time/epoch_s']:.2f} s (host clock); ledger "
        f"{rec['Black-Box Calls']} + {TOOLING_VAL * TOOLING_STRIPS}; CTC "
        f"kernels vs plain at T={lp.shape[0]} B={lp.shape[1]} "
        f"L={labels.shape[1]}: {json.dumps(ctc_errs)} ({card})")
    del trainer

    # (5) the random search (the card has no optuna): 2 patch trials and
    # 1 CRNN trial of one epoch, each trial timed and its parameters kept
    if sweep.HAVE_OPTUNA:
        raise AssertionError("optuna is importable: the sweep would not take "
                             "the random search this phase checks")
    world = {
        "patch": dict(synthetic_train_docs=TOOLING_TRAIN,
                      synthetic_val_docs=TOOLING_VAL,
                      synthetic_strips_per_doc=TOOLING_STRIPS, max_strips=S,
                      batch_docs=D, doc_size=list(DOC_SIZE),
                      unet_features=UNET_FEATURES, lstm_hidden=LSTM_HIDDEN,
                      minibatch_subset="rangeCER", minibatch_subset_prop=0.5,
                      window_size=3, inner_limit=2, inner_limit_skip=True),
        "crnn": dict(synthetic_train_size=AREA_TRAIN,
                     synthetic_val_size=AREA_BATCH, batch_size=AREA_BATCH,
                     lstm_hidden=LSTM_HIDDEN)}
    space = {"patch": [("lr_crnn", 5e-6, 5e-4, True),
                       ("lr_prep", 5e-6, 5e-4, True)],
             "crnn": [("lr", 1e-5, 1e-3, True), ("std", 1, 10, None)]}
    want_counts = {
        "patch": trainer_launches(TOOLING_TRAIN // D, TOOLING_VAL // D,
                                  SWEEP_PATCH_TRIALS),
        "crnn": {"ctc_fwd": SWEEP_CRNN_TRIALS * (AREA_TRAIN // AREA_BATCH
                                                 + 1),
                 "ctc_bwd": SWEEP_CRNN_TRIALS * AREA_TRAIN // AREA_BATCH}}
    for which, n in (("patch", SWEEP_PATCH_TRIALS),
                     ("crnn", SWEEP_CRNN_TRIALS)):
        name = f"{which}_objective"
        objective = getattr(sweep, name)
        trials = []

        def recording(trial, base, objective=objective, trials=trials):
            t0 = time.perf_counter()
            value = objective(trial, base)
            trials.append(dict(params=dict(trial.params), value=value,
                               s=time.perf_counter() - t0))
            return value

        out = os.path.join(work, f"sweep_{which}.json")
        setattr(sweep, name, recording)
        try:
            with conv_impl_cmajor():
                sweep.main(["--which", which, "--n_trials", str(n),
                            "--epoch", "1", "--device", "cuda",
                            "--exp_base_path",
                            os.path.join(work, f"sweep_{which}"),
                            "--world_json", json.dumps(world[which]),
                            "--out", out])
        finally:
            setattr(sweep, name, objective)
        torch.cuda.synchronize()
        add(_expect(f"the {which} sweep", want_counts[which], "tooling"))
        with open(out) as f:
            result = json.load(f)
        want_params = _random_search_params(n, space[which])
        best = max(trials, key=lambda t: t["value"])
        if set(result) != {"best_value", "best_params"} \
                or [t["params"] for t in trials] != want_params \
                or result["best_params"] != best["params"] \
                or result["best_value"] != best["value"]:
            raise AssertionError(f"{which} sweep: {result}, trials {trials}, "
                                 f"seed-0 parameters {want_params}")
        readings[f"sweep_{which}"] = trials
        for i, t in enumerate(trials):
            log(f"[tooling] {which} sweep trial {i}: {json.dumps(t['params'])}"
                f" -> {t['value']:.4f} in {t['s']:.2f} s (one epoch with "
                f"set-up and checkpoints, host clock; {card})")
    # (6) a patch dataset from raw PNG documents through the GVision mock
    from PIL import Image

    from qea_ocr_tpu_torch.data import PatchDocuments

    raw, built = os.path.join(work, "raw"), os.path.join(work, "built")
    os.makedirs(raw)
    docs = PatchDocuments.synthetic(2, seed=TOOLING_SEED, n_strips=2,
                                    max_strips=S, doc_size=DOC_SIZE)
    for i, sample in enumerate(docs.samples):
        Image.fromarray((sample.image * 255).astype(np.uint8), "L").save(
            os.path.join(raw, f"doc{i}.png"))
    t0 = time.perf_counter()
    build_patch_dataset.main(["--src", raw, "--dst", built, "--mock"])
    readings["build_patch_dataset_s"] = time.perf_counter() - t0
    add(_expect("build_patch_dataset", {}, "tooling"))
    for i in range(2):
        name = os.path.join(built, f"doc{i}")
        with open(name + ".png", "rb") as f, \
                open(os.path.join(raw, f"doc{i}.png"), "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"doc{i}.png was not copied as it was")
        with open(name + ".json") as f:
            if json.load(f) != [dict(label="MOCK", x_min=0, y_min=0,
                                     x_max=127, y_max=31)]:
                raise AssertionError(f"doc{i}.json is not the mock's box")
    back = PatchDocuments(built, max_strips=S, doc_size=DOC_SIZE)
    if len(back) != 2 or [int(s.strip_mask.sum()) for s in back.samples] \
            != [1, 1]:
        raise AssertionError("the built dataset does not read back")
    log(f"[tooling] build_patch_dataset --mock: 2 documents of {DOC_SIZE} "
        f"in {readings['build_patch_dataset_s']:.2f} s, read back by "
        f"PatchDocuments with one strip each")

    readings["phase_s"] = time.perf_counter() - t_phase
    log(f"[tooling] kernel launches in this phase: {json.dumps(total)}; "
        f"phase wall time {readings['phase_s']:.2f} s")
    for k in total:
        if total[k] < 1:
            raise AssertionError(f"{k} never launched in the tooling phase")
    return total, readings


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

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = gpu_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {', '.join(p.name for p in libs)} in "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas = check_build()

    # the floor under every small kernel: an empty launch, back to back
    floor_ms = device_ms(torch, lambda: torch.cuda._sleep(0))
    log(f"[kernels] launch floor: torch.cuda._sleep(0) {floor_ms:.4f} ms on "
        f"the device (median, {card})")
    gather_fwd, gather_bwd = check_gather(torch, dev, card)
    ctc_fwd, ctc_bwd = check_ctc(torch, dev, card)
    for record, kernel in ((gather_fwd, "gather_fwd_kernel"),
                           (gather_bwd, "gather_bwd_kernel"),
                           (ctc_fwd, "ctc_alpha_kernel"),
                           (ctc_bwd, "ctc_beta_grad_kernel")):
        record.update(ptxas[kernel])
    conv = {**check_conv(torch, dev, card), **ptxas["conv"]}

    infer_counts, unet, crnn, cm, samples = run_slice(torch, dev, card)
    check_reference(torch, dev, unet, crnn, cm, samples)
    del unet, crnn

    counts = run_train(torch, dev, card, cm)
    check_train_reference(torch, dev, cm)
    with tempfile.TemporaryDirectory() as work:
        trainer_counts, twin, prep_ckpt, single = run_trainer(
            torch, dev, card, os.path.join(work, "trainer"))
        pipeline_counts, pipeline, crnn_ckpt = run_pipeline(
            torch, dev, card, work, prep_ckpt)
        area_counts, area, area_ctc, area_run = run_area(
            torch, dev, card, os.path.join(work, "area"), crnn_ckpt)
        parallel_counts, parallel = run_parallel(
            torch, dev, card, work, single, area_run)
        export, export_launches = run_export(torch, dev, card, work,
                                             prep_ckpt)
        tooling_counts, tooling = run_tooling(torch, dev, card, work, single)
    # the warmup's batch and the area's two shapes are more shapes the CTC
    # kernels were held at
    for errs in (pipeline["warmup_ctc"], *area_ctc.values(),
                 tooling["ctc"]):
        ctc_fwd["max_abs_err"] = max(ctc_fwd["max_abs_err"], errs["nll_abs"])
        ctc_bwd["max_abs_err"] = max(ctc_bwd["max_abs_err"], errs["grad_abs"])

    csrc = "qea_ocr_tpu_torch/csrc/"
    pallas = "qea_ocr_tpu/ops/pallas/"
    # `launches`: the count of the main path that runs the kernel at its
    # shapes above, each read from a run that began with the counts at 0: the
    # training-step phase for the four earlier kernels, the trainer phase
    # for the conv (the only path through it)
    kernels = [
        {"name": name, "route": "cuda", "source": csrc + source,
         "replaces": pallas + replaces,
         "launches": (trainer_counts if key == "conv" else counts)[key],
         "launches_inference": infer_counts[key],
         "launches_train": counts[key],
         "launches_trainer": trainer_counts[key],
         "launches_pipeline": pipeline_counts[key],
         "launches_area": area_counts[key],
         "launches_parallel": parallel_counts[key],
         "launches_tooling": tooling_counts[key],
         **({"launches_export": export_launches} if key == "conv" else {}),
         **record}
        for key, name, source, replaces, record in (
            ("gather_fwd", "gather_fwd", "gather.cu", "gather_pallas.py:113",
             gather_fwd),
            ("gather_bwd", "gather_bwd", "gather.cu", "gather_pallas.py:132",
             gather_bwd),
            ("ctc_fwd", "ctc_alpha_fwd", "ctc.cu", "ctc_pallas.py:42",
             ctc_fwd),
            ("ctc_bwd", "ctc_beta_bwd", "ctc.cu", "ctc_pallas.py:72",
             ctc_bwd),
            ("conv", "conv_cmajor", "conv_cmajor.cu", "conv_cmajor.py:95",
             conv))]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on its path")
    log(f"[trainer] twin vs vanilla: {json.dumps(twin)}")
    log(f"[pipeline] readings: {json.dumps(pipeline)}")
    log(f"[area] readings: {json.dumps(area)}")
    log(f"[export] readings: {json.dumps(export)}")
    log(f"[parallel] readings: {json.dumps(parallel)}")
    log(f"[tooling] readings: {json.dumps(tooling)}")
    log(f"[smoke] wall time {time.perf_counter() - t_start:.1f} s from the "
        f"device check (the build included; {card})")
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
