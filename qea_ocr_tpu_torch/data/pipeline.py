"""Host-to-device step of the port's data path.

Documents, boxes and labels are built on the host by the JAX package's
numpy-only data layer (`qea_ocr_tpu/data/`), which the port imports as it
is; this module moves a collated `DocBatch` onto a torch device.
"""

from __future__ import annotations

import dataclasses

import torch

from qea_ocr_tpu.data.pipeline import DocBatch


@dataclasses.dataclass
class DocTensors:
    """The arrays of a `DocBatch` that the step functions take, as tensors
    on one device."""
    images: torch.Tensor       # (D, 1, H, W) float32
    bboxes: torch.Tensor       # (D, S, 4) int32
    strip_mask: torch.Tensor   # (D, S) bool
    gt_labels: torch.Tensor    # (D, S, L) int32
    gt_lengths: torch.Tensor   # (D, S) int32


def doc_batch_to(batch: DocBatch, device: torch.device) -> DocTensors:
    """Copy `batch`'s arrays to `device`."""
    return DocTensors(**{
        f.name: torch.from_numpy(getattr(batch, f.name)).to(device)
        for f in dataclasses.fields(DocTensors)})
