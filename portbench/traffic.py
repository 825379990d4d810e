"""The one generator of every cell's inputs, from `--seed` and the traffic
file's parameters. Everything is drawn on the run's device from
`torch.Generator`s of its own, in a few large calls, before the window.

The patch batch is `qea_ocr_tpu_torch/tools/bench_batch.py`'s (a frozen
copy of its geometry: uniform-noise documents, boxes of 16..126 x 10..30
pixels placed inside the document, one padded strip slot), extended with
what a budget-aware training step consumes:

  * label lengths drawn per strip in [label_len[0], label_len[1]] (symbols
    1..V-1, padded with V);
  * the OCR's answers for the last `window` queries of each strip (the
    label history, newest first) and for the jitter copy: the ground truth
    with each symbol replaced at rate `ocr_substitution`; depth i of a
    strip's history exists with probability `history_depth_valid[i]` (and
    only after depth i-1);
  * the rangeCER selection's uniform points, and the jitter copy's
    per-strip std (integers 0..jitter_std, /100) and unit normals;
  * a CER table as left by an earlier epoch (uniform in [0, 1]), one row a
    strip of the pool.

A pool of `pool` batches is made and cycled by the window; rows of
different batches are different strips. The area batch is the same with
word crops (B, 1, 32, 128) in place of documents and strips. A serving
request is `docs` documents of heights and widths uniform in the given
ranges (padded into the canvas, never shrunk), made on the device and
handed to the cleaner as float32 numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

STREAMS = {"images": 1, "boxes": 2, "labels": 3, "ocr": 4, "select": 5,
           "jitter": 6, "table": 7, "requests": 8, "sample": 9}


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 7919 + STREAMS[stream] * 104729) % (2 ** 63))
    return g


@dataclass
class Batch:
    """One training batch: `images` (D, 1, H, W) documents or (B, 1, h, w)
    crops; for documents `bboxes` (D, S, 4) and `strip_mask` (D, S); then
    per strip row (N = D*S, or B): `gt_labels` (N, L), `gt_lengths` (N,),
    `strip_ids` (N,), `hist_labels` (N, W, L), `hist_lengths` (N, W),
    `hist_depth` (N, W) bool (the depths that exist), `jitter_labels`
    (N, L), `jitter_lengths` (N,), `sel_noise` (D, S) or (1, B),
    `image_std` (N,), `unit_noise` (N, 1, h, w)."""
    images: torch.Tensor
    bboxes: torch.Tensor | None
    strip_mask: torch.Tensor
    gt_labels: torch.Tensor
    gt_lengths: torch.Tensor
    strip_ids: torch.Tensor
    hist_labels: torch.Tensor
    hist_lengths: torch.Tensor
    hist_depth: torch.Tensor
    jitter_labels: torch.Tensor
    jitter_lengths: torch.Tensor
    sel_noise: torch.Tensor
    image_std: torch.Tensor
    unit_noise: torch.Tensor


def _labels(g, n: int, L: int, V: int, lo: int, hi: int, device):
    lengths = torch.randint(lo, hi + 1, (n,), generator=g, device=device,
                            dtype=torch.int32)
    sym = torch.randint(1, V, (n, L), generator=g, device=device,
                        dtype=torch.int32)
    pos = torch.arange(L, device=device)[None]
    return torch.where(pos < lengths[:, None], sym, V), lengths


def _ocr(g, gt, lengths, V: int, rate: float, copies: int):
    """`copies` OCR answers per row: the ground truth with each symbol
    replaced by a random one at `rate` (lengths kept). (copies, N, L)."""
    n, L = gt.shape
    swap = torch.rand((copies, n, L), generator=g, device=gt.device) < rate
    sym = torch.randint(1, V, (copies, n, L), generator=g, device=gt.device,
                        dtype=torch.int32)
    pos = torch.arange(L, device=gt.device)[None, None]
    live = pos < lengths[None, :, None]
    return torch.where(swap & live, sym, gt[None].expand(copies, n, L))


def training_pool(t: dict, cfg: dict, seed: int, device) -> list[Batch]:
    """`t["pool"]` batches of the cell's traffic, with strip ids
    0 .. pool*N - 1 in order."""
    V, L = cfg["vocab_size"], cfg["max_label_len"]
    h, w = cfg["strip_size"]
    docs = t["pipeline"] == "patch"
    gi, gb, gl, go, gs, gj = (generator(seed, s, device) for s in (
        "images", "boxes", "labels", "ocr", "select", "jitter"))
    W = t["window"]
    out = []
    for k in range(t["pool"]):
        if docs:
            D, S = t["docs"], cfg["strip_slots"]
            H, Wd = cfg["doc_size"]
            images = torch.rand((D, 1, H, Wd), generator=gi, device=device)
            x0 = torch.randint(0, Wd - 132, (D, S), generator=gb,
                               device=device)
            y0 = torch.randint(0, H - 40, (D, S), generator=gb, device=device)
            bw = torch.randint(t["box_w"][0], t["box_w"][1] + 1, (D, S),
                               generator=gb, device=device)
            bh = torch.randint(t["box_h"][0], t["box_h"][1] + 1, (D, S),
                               generator=gb, device=device)
            bboxes = torch.stack([x0, y0, x0 + bw, y0 + bh], -1).int()
            mask = torch.ones((D, S), dtype=torch.bool, device=device)
            mask[0, S - t["masked_slots"]:] = False
            sel_shape = (D, S)
        else:
            D = t["crops"]
            images = torch.rand((D, 1, h, w), generator=gi, device=device)
            bboxes = None
            mask = torch.ones((1, D), dtype=torch.bool, device=device)
            sel_shape = (1, D)
        N = mask.numel()
        gt, glen = _labels(gl, N, L, V, *t["label_len"], device)
        answers = _ocr(go, gt, glen, V, t["ocr_substitution"], W + 1)
        depth = torch.rand((N, W), generator=go, device=device) < torch.tensor(
            t["history_depth_valid"], device=device)
        depth = torch.cumprod(depth.int(), dim=1).bool()
        out.append(Batch(
            images=images, bboxes=bboxes, strip_mask=mask, gt_labels=gt,
            gt_lengths=glen,
            strip_ids=torch.arange(k * N, (k + 1) * N, device=device,
                                   dtype=torch.int32),
            hist_labels=answers[:W].transpose(0, 1).contiguous(),
            hist_lengths=glen[:, None].expand(N, W).contiguous(),
            hist_depth=depth, jitter_labels=answers[W].contiguous(),
            jitter_lengths=glen.clone(),
            sel_noise=torch.rand(sel_shape, generator=gs, device=device),
            image_std=torch.randint(0, t["jitter_std"] + 1, (N,),
                                    generator=gj, device=device).float()
            / 100.0,
            unit_noise=torch.randn((N, 1, h, w), generator=gj,
                                   device=device)))
    return out


def cer_table(t: dict, n_rows: int, seed: int, device) -> torch.Tensor:
    """The CER of every strip of the pool as an earlier epoch left it."""
    return torch.rand((n_rows,), generator=generator(seed, "table", device),
                      device=device)


def serve_pool(t: dict, seed: int, device) -> list[list[np.ndarray]]:
    """`t["pool"]` requests of `t["docs"]` float32 (h, w) documents in
    [0, 1], h and w uniform in the traffic's ranges."""
    g = generator(seed, "requests", device)
    (h0, h1), (w0, w1) = t["heights"], t["widths"]
    n = t["pool"] * t["docs"]
    hs = torch.randint(h0, h1 + 1, (n,), generator=g, device=device).tolist()
    ws = torch.randint(w0, w1 + 1, (n,), generator=g, device=device).tolist()
    flat = torch.rand((sum(a * b for a, b in zip(hs, ws)),), generator=g,
                      device=device).cpu().numpy()
    docs, at = [], 0
    for a, b in zip(hs, ws):
        docs.append(flat[at:at + a * b].reshape(a, b))
        at += a * b
    return [docs[i * t["docs"]:(i + 1) * t["docs"]]
            for i in range(t["pool"])]
