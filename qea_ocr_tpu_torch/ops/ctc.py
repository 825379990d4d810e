"""CTC loss and greedy decoding (counterpart of `qea_ocr_tpu/ops/ctc.py`).

Scores are time-major log-probs `(T, B, V)`; labels are `(B, L)` int32
padded with `pad_id` (== vocab size); `blank_id` is 0.

The loss has the TPU kernels' semantics everywhere (`ops/cuda/ctc_cuda.py`):
on CUDA tensors it is the hand-written alpha and beta recursion kernels of
`csrc/ctc.cu`, on CPU tensors their plain PyTorch versions. A row that no
alignment fits scores exactly 1e5 and has gradient exactly 0. Gradients
flow to the scores only.

`logit_lengths` (B,) gives each row's valid steps, as in JAX: row b uses
its first `logit_lengths[b]` steps, in [1, T] (anything else raises
`ValueError`), and its gradient is exactly 0 after them. The JAX package
takes optax's path for it, which scores a row no alignment fits near 1e5
instead of exactly 1e5; the port keeps its kernels' semantics.
"""

from __future__ import annotations

import torch

from qea_ocr_tpu_torch.ops.cuda import ctc_cuda
from qea_ocr_tpu_torch.parallel.multihost import global_count, global_mean
from qea_ocr_tpu_torch.utils.metrics import span


def ctc_loss_samplewise(scores: torch.Tensor, labels: torch.Tensor,
                        label_lengths: torch.Tensor, *, pad_id: int,
                        blank_id: int = 0,
                        logit_lengths: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Per-sample CTC NLL, (B,) float32 (not length-normalised)."""
    with span("ctc"):
        return ctc_cuda.ctc_nll(scores.float().contiguous(),
                                labels.int().contiguous(),
                                label_lengths.int().contiguous(), pad_id,
                                blank_id, logit_lengths)


def ctc_loss_mean(scores: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor, *, pad_id: int,
                  blank_id: int = 0,
                  logit_lengths: torch.Tensor | None = None,
                  sample_mask: torch.Tensor | None = None) -> torch.Tensor:
    """torch `CTCLoss(reduction='mean')` normalisation: the mean over the
    batch of `nll_b / max(1, len_b)`, restricted to `sample_mask` if given.
    Inside `multihost.data_group` the count is the global batch's, so the
    result is this rank's share of the global mean."""
    per_seq = ctc_loss_samplewise(scores, labels, label_lengths,
                                  pad_id=pad_id, blank_id=blank_id,
                                  logit_lengths=logit_lengths)
    normed = per_seq / label_lengths.float().clamp(min=1.0)
    if sample_mask is None:
        return global_mean(normed)
    m = sample_mask.float()
    return (normed * m).sum() / global_count(m.sum()).clamp(min=1.0)


def greedy_decode(scores: torch.Tensor, *, pad_id: int,
                  blank_id: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Argmax per step, collapse repeats, drop blanks.

    Returns decoded (B, T) int32 ids, pad-filled with `pad_id`, and the
    decoded lengths (B,) int32."""
    T = scores.shape[0]
    ids = scores.argmax(dim=-1).T                                   # (B, T)
    prev = torch.cat([torch.full_like(ids[:, :1], blank_id), ids[:, :-1]], 1)
    keep = (ids != blank_id) & (ids != prev)
    # kept symbols land at their running rank; dropped ones in column T,
    # which is cut off afterwards
    pos = torch.where(keep, keep.long().cumsum(dim=1) - 1, T)
    out = torch.full((ids.shape[0], T + 1), pad_id, dtype=ids.dtype,
                     device=ids.device)
    out.scatter_(1, pos, ids)
    return out[:, :T].int(), keep.sum(dim=1).int()
