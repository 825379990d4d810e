"""The differentiable OCR proxy that the trainers build, by name.

`crnn` is the reference's CRNN (T = 31 steps); `svtr-l` is the
transformer recognizer of `models/svtr.py` at its published widths
(T = 32). Every proxy maps (B, 1, 32, 128) crops to
time-major (T, B, V) float32 log-probs, which is all the steps, the CTC
kernels and the selection read.
"""

from __future__ import annotations

import torch
from torch import nn

from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.models.svtr import PRESETS, SVTR

PROXIES = ("crnn", *PRESETS)


def build_proxy(name: str, vocab_size: int, *, lstm_hidden: int = 256,
                compute_dtype: torch.dtype = torch.bfloat16,
                generator: torch.Generator | None = None) -> nn.Module:
    """The proxy `name` (one of `PROXIES`); `lstm_hidden` is the CRNN's."""
    if name == "crnn":
        return CRNN(vocab_size, lstm_hidden=lstm_hidden,
                    compute_dtype=compute_dtype, generator=generator)
    if name in PRESETS:
        return SVTR.preset(name, vocab_size, compute_dtype=compute_dtype,
                           generator=generator)
    raise ValueError(f"unknown proxy {name!r}: one of {', '.join(PROXIES)}")
