"""Loss-weight generators over the label history (counterpart of
`qea_ocr_tpu/tracking/weights.py`, reference
`label_tracking/tracking_methods.py:12-124`).

All generators but the first produce `(B, window+1)` float32 weights whose
column 0 (the current epoch's fresh OCR label) is fixed at 1.0, matching the
reference convention (`tracking_methods.py:49,85`).

  * decaying       - closed-form [decay^0 .. decay^(W-1)], shape (W,)
                     (`tracking_methods.py:105-115`; per-depth scalars, not
                     per-sample)
  * levenshtein    - consensus weighting: slots whose label agrees with the
                     rest of the history get weight near 0.5, outliers near 0
                     (`tracking_methods.py:63-101`); pairwise distances run
                     as one batched device DP
  * self_attention - the `HistoryAttention` module applied to all strips at
                     once (`tracking_methods.py:26-59`)
"""

from __future__ import annotations

from typing import Callable

import torch

from qea_ocr_tpu_torch.ops.edit_distance import batched_levenshtein


def decaying_weights(decay_factor: float, window_size: int,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """(W,) float32 per-depth scalars [decay^0 .. decay^(W-1)] (reference
    `tracking_methods.py:105-115`)."""
    return torch.tensor([decay_factor ** i for i in range(window_size)],
                        dtype=torch.float32, device=device)


@torch.no_grad()
def levenshtein_weights(hist_labels: torch.Tensor,    # (B, W, L) int32
                        hist_lengths: torch.Tensor,   # (B, W) int32
                        hist_valid: torch.Tensor,     # (B, W) bool
                        ) -> torch.Tensor:
    """(B, W+1) consensus weights.

    For each valid slot i: w = 0.5 * (1 - min(mean_dist_i, len_i) / len_i),
    where mean_dist_i averages the Levenshtein distance to every *other*
    valid slot of the (possibly shorter-than-W) history, divided by
    max(hist_len - 1, 1)."""
    B, W, L = hist_labels.shape
    # all slot pairs as one batch of B*W*W rows: a walks the slow pair axis
    a = hist_labels.repeat_interleave(W, dim=1).reshape(B * W * W, L)
    a_len = hist_lengths.repeat_interleave(W, dim=1).reshape(B * W * W)
    b = hist_labels.repeat(1, W, 1).reshape(B * W * W, L)
    b_len = hist_lengths.repeat(1, W).reshape(B * W * W)
    dists = batched_levenshtein(a, a_len, b, b_len).reshape(B, W, W).float()

    validf = hist_valid.float()
    pair_valid = validf[:, :, None] * validf[:, None, :]
    pair_valid = pair_valid * (1.0 - torch.eye(W, device=validf.device))
    hist_len = validf.sum(dim=1, keepdim=True)                 # (B, 1)
    num_elements = (hist_len - 1.0).clamp(min=1.0)
    dist_mean = (dists * pair_valid).sum(dim=2) / num_elements  # (B, W)
    num_chars = hist_lengths.float().clamp(min=1.0)
    w = 0.5 * (1.0 - torch.minimum(dist_mean, num_chars) / num_chars)
    return torch.cat([w.new_ones((B, 1)), w * validf], dim=1)


@torch.no_grad()
def attention_weights(attention: Callable[[torch.Tensor], torch.Tensor],
                      hist_labels: torch.Tensor,   # (B, W, L)
                      hist_valid: torch.Tensor,    # (B, W)
                      ) -> torch.Tensor:
    """(B, W+1) attention-generated weights; invalid slots zeroed.
    `attention` is a `HistoryAttention` module (or any callable from
    (B, W, L) char indices to (B, W) weights)."""
    w = attention(hist_labels).float() * hist_valid.float()
    return torch.cat([w.new_ones((w.shape[0], 1)), w], dim=1)


WEIGHTGEN_METHODS = ("decaying", "levenshtein", "self_attention")


def weightgenerator_factory(method: str) -> str:
    """Name check parity with `tracking_methods.py:118-124`; the trainers
    dispatch on the returned name (functional generators, not classes)."""
    if method not in WEIGHTGEN_METHODS:
        raise KeyError(method)
    return method
