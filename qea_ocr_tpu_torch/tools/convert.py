"""Carry JAX weights into the port (built on
`qea_ocr_tpu/tools/export_torch.py`).

The JAX package's exporter already maps flax `{'params', 'batch_stats'}`
trees to the reference-schema state_dicts (HWIO -> OIHW, flipped
ConvTranspose kernels, BN stats, per-gate LSTM kernels fused with the one
flax bias as `bias_hh`). The port's models use that schema, so converting is
the exporter plus numpy -> torch.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from qea_ocr_tpu.tools.export_torch import (
    state_dict_from_crnn, state_dict_from_unet)


def _to_torch(sd) -> "OrderedDict[str, torch.Tensor]":
    return OrderedDict((k, torch.from_numpy(np.array(v))) for k, v in sd.items())


def unet_state_dict(variables: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX UNet `{'params', 'batch_stats'}` (numpy leaves) -> state_dict of
    `qea_ocr_tpu_torch.models.unet.UNet`."""
    return _to_torch(state_dict_from_unet(variables))


def crnn_state_dict(variables: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX CRNN `{'params', 'batch_stats'}` (numpy leaves) -> state_dict of
    `qea_ocr_tpu_torch.models.crnn.CRNN`."""
    return _to_torch(state_dict_from_crnn(variables))


def load_state_dict_file(path: str) -> "OrderedDict[str, torch.Tensor]":
    """A state_dict pickle (e.g. written by `export_torch.export_prep`),
    loaded as plain tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
