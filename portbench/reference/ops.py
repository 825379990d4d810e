"""Plain versions of the operations around the models: the strip gather,
the CTC loss, greedy decoding, the edit distance and CER, the entropy, the
rangeCER selection and Adam with coupled L2. Float32 PyTorch and NumPy,
written from the semantics the system documents; nothing of the program
is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BLANK = 0


def gather_strips(docs, bboxes, h_out: int = 32, w_out: int = 128):
    """docs (D, 1, H, W), boxes (D, S, 4) [x0, y0, x1, y1] -> (D*S, 1, h,
    w): each box cropped out of its document and centred in a white tile;
    source rows and columns clamp to the document's edge. Differentiable
    in the documents (autograd through `torch.gather` adds each tile cell
    into the pixel it read)."""
    D, _, H, W = docs.shape
    S = bboxes.shape[1]
    b = bboxes.long()
    x0, y0, x1, y1 = b.unbind(-1)
    top = torch.div(h_out - (y1 - y0), 2, rounding_mode="floor")
    left = torch.div(w_out - (x1 - x0), 2, rounding_mode="floor")
    rows = (y0 - top)[..., None] + torch.arange(h_out, device=docs.device)
    cols = (x0 - left)[..., None] + torch.arange(w_out, device=docs.device)
    inside = (((rows >= y0[..., None]) & (rows < y1[..., None]))[..., :, None]
              & ((cols >= x0[..., None]) & (cols < x1[..., None]))[..., None, :])
    idx = (rows.clamp(0, H - 1)[..., :, None] * W
           + cols.clamp(0, W - 1)[..., None, :])
    tiles = torch.gather(docs.reshape(D, H * W), 1, idx.reshape(D, -1))
    tiles = tiles.reshape(D, S, h_out, w_out)
    tiles = torch.where(inside, tiles, torch.ones((), device=docs.device))
    return tiles.reshape(D * S, 1, h_out, w_out)


def ctc_nll(log_probs, labels, lengths):
    """(T, B, V) log-probs, (B, L) labels, (B,) lengths -> (B,) NLL over
    all T steps (blank 0). Rows are feasible in this benchmark's traffic."""
    T, B, _ = log_probs.shape
    if B == 0:
        return log_probs.new_zeros(0)
    ln = lengths.long()
    L = labels.shape[1]
    mask = torch.arange(L, device=labels.device)[None] < ln[:, None]
    targets = labels.long()[mask]
    return F.ctc_loss(log_probs, targets,
                      torch.full((B,), T, dtype=torch.long,
                                 device=log_probs.device),
                      ln, blank=BLANK, reduction="none", zero_infinity=False)


def greedy_decode(scores):
    """(T, B, V) -> list of B int lists: argmax a step, repeats collapsed,
    blanks dropped."""
    ids = scores.argmax(dim=-1).T.cpu().numpy()
    out = []
    for row in ids:
        seq, prev = [], BLANK
        for s in row:
            if s != BLANK and s != prev:
                seq.append(int(s))
            prev = s
        out.append(seq)
    return out


def edit_distance(a, b) -> int:
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def cer(pred, gt) -> float:
    """Levenshtein distance over max(1, len(gt)), in float32 as stored."""
    return float(np.float32(edit_distance(pred, gt))
                 / np.float32(max(1, len(gt))))


def entropy(scores):
    """(T, B, V) log-probs -> (B,) mean over steps of the entropy divided
    by log V (probabilities offset by 1e-6 inside the log)."""
    p = scores.exp()
    ent = -(p * torch.log(p + 1e-6)).sum(dim=-1) / math.log(scores.shape[-1])
    return ent.mean(dim=0)


def decode_gap(scores, decoded, decoded_len):
    """How far below the best a greedy decode had to reach: for each row,
    over the step-by-step paths whose collapse (repeats merged, blanks
    dropped) is the program's decoded sequence, the least of the path's
    widest gap between a step's best log-prob and the log-prob of the
    path's token there; +inf where no path gives it. (B,) float.

    scores (T, B, V) of the reference, decoded (B, >=n) int, decoded_len
    (B,). A dynamic program over CTC's extended sequence with max-min."""
    T, B, V = scores.shape
    gaps = (scores.max(dim=-1, keepdim=True).values - scores)    # (T, B, V)
    n_max = int(decoded_len.max()) if B else 0
    S = 2 * n_max + 1
    lab = torch.full((B, max(n_max, 1)), BLANK, dtype=torch.long,
                     device=scores.device)
    pos = torch.arange(max(n_max, 1), device=scores.device)[None]
    ln = decoded_len.long().to(scores.device)
    dec = decoded[:, :max(n_max, 1)].long().to(scores.device)
    lab = torch.where(pos < ln[:, None], dec, lab)
    ext = torch.full((B, S), BLANK, dtype=torch.long, device=scores.device)
    ext[:, 1::2] = lab[:, :n_max]
    elen = 2 * ln + 1
    s_idx = torch.arange(S, device=scores.device)[None]
    live = s_idx < elen[:, None]
    prev2 = torch.cat([torch.full((B, 2), -1, device=scores.device,
                                  dtype=torch.long), ext[:, :-2]], 1)
    skip = (ext != BLANK) & (ext != prev2)
    inf = torch.tensor(float("inf"), device=scores.device)
    cost = lambda t: gaps[t].gather(1, ext)                      # (B, S)
    a = torch.where(s_idx < 2, cost(0), inf)
    a = torch.where(live, a, inf)
    for t in range(1, T):
        a1 = torch.cat([torch.full((B, 1), float("inf"),
                                   device=scores.device), a[:, :-1]], 1)
        a2 = torch.cat([torch.full((B, 2), float("inf"),
                                   device=scores.device), a[:, :-2]], 1)
        best = torch.minimum(a, a1)
        best = torch.where(skip, torch.minimum(best, a2), best)
        a = torch.where(live, torch.maximum(best, cost(t)), inf)
    last = a.gather(1, (elen - 1)[:, None])[:, 0]
    before = torch.where(elen >= 2, a.gather(1, (elen - 2).clamp(min=0)
                                              [:, None])[:, 0], inf)
    return torch.minimum(last, before)


def range_cer_select(estimates, valid, noise, prop: float):
    """rangeCER (the reference's CerRangeSampler) on each document's
    estimates: S uniform points over [min, max] of its valid estimates,
    point i claiming the nearest estimate not yet claimed (claimed ones
    become 100); a slot's rank is the first point that claimed it; the
    first k = max(1, ceil(n_valid (1 - prop))) ranks (at most n_valid)
    query. numpy float32 on (D, S) arrays -> (D, S) bool."""
    est = np.asarray(estimates, np.float32)
    valid = np.asarray(valid, bool)
    noise = np.asarray(noise, np.float32)
    D, S = est.shape
    out = np.zeros((D, S), bool)
    for d in range(D):
        v = valid[d]
        n = int(v.sum())
        if n == 0:
            continue
        lo = np.float32(est[d][v].min())
        hi = np.float32(est[d][v].max())
        points = lo + (hi - lo) * noise[d]
        e = np.where(v, est[d], np.float32(np.inf)).astype(np.float32)
        rank = np.full(S, 10 ** 6)
        for i in range(S):
            j = int(np.argmin(np.abs(points[i] - e)))
            e[j] = np.float32(100.0)
            rank[j] = min(rank[j], i)
        k = max(1, math.ceil(np.float32(n) * np.float32(1.0 - prop)))
        k = min(k, n)
        out[d] = v & (rank < k)
    return out


class Adam:
    """Adam with coupled L2 (the gradient plus wd * param, then Adam; betas
    0.9 and 0.999, eps 1e-8 outside the square root) over a dict of
    leaves."""

    def __init__(self, params: dict, lr: float, wd: float):
        self.params, self.lr, self.wd, self.t = params, lr, wd, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, p in self.params.items():
            g = grads[k] + self.wd * p
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = (self.v[k] / c2).sqrt() + 1e-8
            p.sub_(self.lr * (self.m[k] / c1) / denom)


def jitter(images, image_std, unit_noise):
    """The jitter copy: clamp(images - (std + 1e-13) * N(0, 1), 0, 1) with
    the per-image std and the normals given."""
    B = images.shape[0]
    s = (image_std.float() + 1e-13).reshape((B,) + (1,) * (images.dim() - 1))
    return torch.clamp(images - unit_noise.float() * s, 0.0, 1.0)
