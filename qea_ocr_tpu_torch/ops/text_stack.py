"""Batched text-strip extraction (counterpart of `qea_ocr_tpu/ops/text_stack.py`).

Every strip is a fixed-shape crop of its document, centred in an
`h_out x w_out` tile and padded white (1.0). Boxes are `(D, S, 4)` int
`[x_min, y_min, x_max, y_max]` in document pixels; masked slots may hold
any dummy box (callers carry a separate strip mask). A box that pokes out
of its document repeats the edge pixels (the JAX XLA path's clamping).

On CUDA tensors this is the hand-written kernel `csrc/gather.cu`, for any
document size; on CPU tensors its plain PyTorch version
(`ops/cuda/gather_cuda.py`).
"""

from __future__ import annotations

import torch

from qea_ocr_tpu_torch.ops.cuda import gather_cuda


def get_text_stack_batch(docs: torch.Tensor, bboxes: torch.Tensor,
                         h_out: int = 32, w_out: int = 128) -> torch.Tensor:
    """docs (D, 1, H, W) float32, bboxes (D, S, 4) int32
    -> (D, S, 1, h_out, w_out) strips."""
    return gather_cuda.text_stack(docs, bboxes, h_out, w_out)[:, :, None]
