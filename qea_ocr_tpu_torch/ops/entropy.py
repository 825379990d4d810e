"""Prediction entropy of CRNN outputs (counterpart of
`qea_ocr_tpu/ops/entropy.py`), used by the `uniformEntropy` selection."""

from __future__ import annotations

import math

import torch


def normalized_entropy(probs: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Entropy over the last axis divided by log(num_classes)."""
    entropy = -(probs * torch.log(probs + 1e-6)).sum(dim=-1)
    return entropy / math.log(num_classes)


def mean_sequence_entropy(scores: torch.Tensor,
                          num_classes: int | None = None) -> torch.Tensor:
    """(T, B, V) log-probs -> (B,) mean per-step normalised entropy."""
    if num_classes is None:
        num_classes = scores.shape[-1]
    return normalized_entropy(torch.exp(scores), num_classes).mean(dim=0)
