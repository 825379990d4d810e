"""The plain reference of the cleaner's canvas: each document centred on a
white canvas (never shrunk: the traffic sends none larger) and quantised
to uint8 as the service receives it, then read back as float in [0, 1]."""

from __future__ import annotations

import numpy as np
import torch


def canvas(docs, H: int, W: int, device):
    """(len(docs), 1, H, W) float32 canvases and each document's
    (top, left, h, w) inside its canvas."""
    out = np.full((len(docs), 1, H, W), 255, np.uint8)
    geoms = []
    for i, d in enumerate(docs):
        h, w = d.shape
        if h > H or w > W:
            raise ValueError(f"document {h}x{w} does not fit the canvas")
        top, left = (H - h) // 2, (W - w) // 2
        out[i, 0, top:top + h, left:left + w] = np.round(
            np.clip(d, 0, 1) * 255.0).astype(np.uint8)
        geoms.append((top, left, h, w))
    return torch.from_numpy(out).to(device).float() / 255.0, geoms
