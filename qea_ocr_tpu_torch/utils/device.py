"""Explicit device selection (counterpart of `qea_ocr_tpu/utils/platform.py`).

Every entry point of the port names its device. A request for a CUDA device
that is not there raises: nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """`"cpu"`, `"cuda"` or `"cuda:N"` -> a `torch.device` that exists."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {device!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use cpu or cuda")
    return dev
