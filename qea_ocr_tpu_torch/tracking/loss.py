"""Weighted CTC loss over label-history depths, one batched device call
(counterpart of `qea_ocr_tpu/tracking/loss.py`; reference
`tracking_utils.py:59-75`).

All (B, window) targets fold into one (B*W,) CTC batch; masks handle the
sparsity.

  * "decaying": per depth i, scalar weight i times the mean over the depth's
    valid rows of the length-normalised NLL (torch `CTCLoss(mean)`);
  * otherwise: per-(sample, depth) weights times the samplewise NLL, not
    length-normalised (as the reference), averaged over the depth's valid
    rows. Depth i pairs with weight column i: column 0 is the constant 1.0
    of the freshly appended OCR label, history slot j carries w(h_{j-1}),
    and the last generated column goes unused.
Depths with no valid samples contribute 0. Inside `multihost.data_group`
the valid rows of a depth are counted over the global batch.
"""

from __future__ import annotations

import torch

from qea_ocr_tpu_torch.ops.ctc import ctc_loss_samplewise
from qea_ocr_tpu_torch.parallel.multihost import global_count


def weighted_ctc_loss(scores: torch.Tensor, hist_labels: torch.Tensor,
                      hist_lengths: torch.Tensor, hist_valid: torch.Tensor,
                      loss_weights: torch.Tensor, *, pad_id: int,
                      decaying: bool, blank_id: int = 0) -> torch.Tensor:
    """scores (T, B, V) log-probs, hist_labels (B, W, L) int32, hist_lengths
    (B, W) int32, hist_valid (B, W) bool, loss_weights (W,) when `decaying`
    else (B, W+1) -> scalar."""
    B = scores.shape[1]
    W, L = hist_labels.shape[1:]
    # row b*W + i holds sample b at depth i
    per = ctc_loss_samplewise(
        scores.repeat_interleave(W, dim=1), hist_labels.reshape(B * W, L),
        hist_lengths.reshape(B * W), pad_id=pad_id, blank_id=blank_id
    ).reshape(B, W)
    validf = hist_valid.float()
    # valid rows a depth, of the global batch inside a data group
    denom = global_count(validf.sum(dim=0)).clamp(min=1.0)        # (W,)
    if decaying:
        per = per / hist_lengths.float().clamp(min=1.0)
        per_depth = (per * validf).sum(dim=0) / denom
        return (loss_weights[:W] * per_depth).sum()
    per_depth = (per * loss_weights[:, :W] * validf).sum(dim=0) / denom
    return per_depth.sum()
