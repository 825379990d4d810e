"""No-grad step functions of the patch trainer (counterpart of the
inference part of `qea_ocr_tpu/train/patch_steps.py`).

  prep_extract : UNet eval forward + strip gather -> (doc_out, strips)
  val_forward  : prep_extract + CRNN eval + per-document loss + greedy decode
  entropy_of   : CRNN eval + mean sequence entropy

Shapes: D documents x S strip slots flatten to N = D*S strip rows; ragged
quantities carry masks. Every function runs its models in eval mode under
`torch.no_grad()` and leaves each model's train/eval mode as it found it.
Nothing here updates weights; the two-phase training step is not ported
yet.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import torch
from torch import nn

from qea_ocr_tpu_torch.ops.ctc import ctc_loss_samplewise, greedy_decode
from qea_ocr_tpu_torch.ops.entropy import mean_sequence_entropy
from qea_ocr_tpu_torch.ops.text_stack import get_text_stack_batch


@contextlib.contextmanager
def _eval_mode(*models: nn.Module):
    modes = [m.training for m in models]
    try:
        for m in models:
            m.eval()
        with torch.no_grad():
            yield
    finally:
        for m, mode in zip(models, modes):
            m.train(mode)


def make_steps(prep_model: nn.Module, crnn_model: nn.Module, charmap, *,
               h_out: int = 32, w_out: int = 128,
               sec_loss_scalar: float = 1.0) -> SimpleNamespace:
    pad_id = charmap.pad_id
    max_len = charmap.max_len

    def _per_doc_loss(scores, flat_labels, flat_lengths, strip_mask, doc_out):
        """Each real document contributes the mean over its own strips of
        the length-normalised CTC NLL plus sec_loss_scalar * MSE(doc,
        white); the result is the mean over documents with any valid strip
        (the reference's batch-size-1 weighting, batched)."""
        D, S = strip_mask.shape
        per = ctc_loss_samplewise(scores, flat_labels, flat_lengths,
                                  pad_id=pad_id)
        per = per / flat_lengths.clamp(min=1).to(per.dtype)
        m = strip_mask.to(per.dtype)
        per_doc_ctc = ((per.reshape(D, S) * m).sum(dim=1)
                       / m.sum(dim=1).clamp(min=1.0))
        per_doc_mse = ((doc_out - 1.0) ** 2).mean(dim=(1, 2, 3))
        per_doc = per_doc_ctc + sec_loss_scalar * per_doc_mse
        doc_mask = strip_mask.any(dim=1).to(per.dtype)
        return (per_doc * doc_mask).sum() / doc_mask.sum().clamp(min=1.0)

    def _extract(images, bboxes):
        D, S = bboxes.shape[:2]
        doc_out = prep_model(images)
        strips = get_text_stack_batch(doc_out, bboxes, h_out, w_out)
        return doc_out, strips.reshape(D * S, 1, h_out, w_out)

    def prep_extract(images, bboxes):
        """UNet eval forward + strip gather: (doc_out (D, 1, H, W),
        strips (D*S, 1, h_out, w_out))."""
        with _eval_mode(prep_model):
            return _extract(images, bboxes)

    def val_forward(images, bboxes, strip_mask, gt_labels, gt_lengths):
        """Validation forward: (doc_out, strips, decoded (N, T) int32,
        decoded lengths (N,) int32, loss scalar)."""
        D, S = bboxes.shape[:2]
        N = D * S
        with _eval_mode(prep_model, crnn_model):
            doc_out, strips = _extract(images, bboxes)
            scores = crnn_model(strips)
            loss = _per_doc_loss(scores, gt_labels.reshape(N, max_len),
                                 gt_lengths.reshape(N), strip_mask, doc_out)
            dec, dec_len = greedy_decode(scores, pad_id=pad_id)
        return doc_out, strips, dec, dec_len, loss

    def entropy_of(strips):
        """(N, 1, h, w) strips -> (N,) mean normalised CRNN entropy."""
        with _eval_mode(crnn_model):
            return mean_sequence_entropy(crnn_model(strips))

    return SimpleNamespace(prep_extract=prep_extract, val_forward=val_forward,
                           entropy_of=entropy_of)
