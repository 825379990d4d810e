"""Batched text-strip extraction (counterpart of `qea_ocr_tpu/ops/text_stack.py`).

Every strip is a fixed-shape crop of its document, centred in an
`h_out x w_out` tile and padded white (1.0). Boxes are `(D, S, 4)` int
`[x_min, y_min, x_max, y_max]` in document pixels; masked slots may hold
any dummy box (callers carry a separate strip mask). A box that pokes out
of its document repeats the edge pixels (the JAX XLA path's clamping).

On CUDA tensors this is the hand-written kernel pair of `csrc/gather.cu`
(forward, and the backward that adds strip gradients into the documents),
for any document size; on CPU tensors its plain PyTorch version
(`ops/cuda/gather_cuda.py`). Gradients flow to the documents only.
"""

from __future__ import annotations

import torch

from qea_ocr_tpu_torch.ops.cuda import gather_cuda
from qea_ocr_tpu_torch.utils.metrics import backward_from, backward_to, span


def get_text_stack(doc: torch.Tensor, bboxes: torch.Tensor,
                   h_out: int = 32, w_out: int = 128) -> torch.Tensor:
    """One document: doc (H, W) or (1, H, W) float32, bboxes (S, 4) int32
    -> (S, 1, h_out, w_out) strips. The batched gather with D=1."""
    if doc.dim() == 2:
        doc = doc[None]
    return gather_cuda.text_stack(doc[None], bboxes[None], h_out,
                                  w_out)[0, :, None]


def get_text_stack_batch(docs: torch.Tensor, bboxes: torch.Tensor,
                         h_out: int = 32, w_out: int = 128) -> torch.Tensor:
    """docs (D, 1, H, W) float32, bboxes (D, S, 4) int32
    -> (D, S, 1, h_out, w_out) strips."""
    with span("gather"):
        docs = backward_to(docs, "gather.backward")
        return backward_from(
            gather_cuda.text_stack(docs, bboxes, h_out, w_out)[:, :, None],
            "gather.backward")
