"""Batched Levenshtein distance and CER on the device (counterpart of
`qea_ocr_tpu/ops/edit_distance.py`).

Row DP over the first sequence; the left-to-right dependency inside a row
is resolved with the min-plus prefix trick

    new[j] = j + cummin_{k<=j}(d[k] - k),  d[j] = min(prev[j]+1, prev[j-1]+cost_j)

so each of the L1 rows is a handful of batched tensor ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def batched_levenshtein(a: torch.Tensor, a_len: torch.Tensor,
                        b: torch.Tensor, b_len: torch.Tensor) -> torch.Tensor:
    """Edit distance between (B, L1) and (B, L2) int sequences of true
    lengths a_len, b_len (B,). Returns (B,) int32."""
    B, L1 = a.shape
    L2 = b.shape[1]
    a = a.long()
    b = b.long()
    j = torch.arange(L2 + 1, device=a.device)
    row = j.expand(B, L2 + 1)
    for i in range(L1):
        cost = (b != a[:, i:i + 1]).long()                        # (B, L2)
        d = torch.minimum(row[:, 1:] + 1, row[:, :-1] + cost)
        d = torch.cat([torch.full((B, 1), i + 1, device=a.device), d], 1)
        new = torch.cummin(d - j, dim=1).values + j
        row = torch.where((i < a_len)[:, None], new, row)
    return row.gather(1, b_len.long()[:, None])[:, 0].int()


def cer_from_labels(pred: torch.Tensor, pred_len: torch.Tensor,
                    gt: torch.Tensor, gt_len: torch.Tensor) -> torch.Tensor:
    """Per-sample CER = levenshtein(pred, gt) / max(1, len(gt)), (B,) float32."""
    dist = batched_levenshtein(pred, pred_len, gt, gt_len)
    return dist.float() / gt_len.float().clamp(min=1.0)


def compare_labels_device(pred: torch.Tensor, pred_len: torch.Tensor,
                          gt: torch.Tensor, gt_len: torch.Tensor,
                          mask: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(exact-match count, CER sum, per-sample CER (B,)); exact means equal
    lengths and equal symbols up to the length. `mask` drops rows from both
    sums."""
    Lp = pred.shape[1]
    Lg = gt.shape[1]
    L = max(Lp, Lg)
    pad_p = F.pad(pred.long(), (0, L - Lp), value=-1)
    pad_g = F.pad(gt.long(), (0, L - Lg), value=-2)
    pos = torch.arange(L, device=pred.device)[None, :]
    vp = pos < pred_len[:, None]
    vg = pos < gt_len[:, None]
    same = torch.where(vg | vp, (pad_p == pad_g) & (vp == vg), True)
    exact = same.all(dim=1) & (pred_len == gt_len)
    cer = cer_from_labels(pred, pred_len, gt, gt_len)
    exact_f = exact.float()
    if mask is not None:
        m = mask.float()
        exact_f = exact_f * m
        cer_sum = (cer * m).sum()
    else:
        cer_sum = cer.sum()
    return exact_f.sum(), cer_sum, cer
