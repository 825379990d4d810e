"""Experiment directories, JSON side-state, PNG output and checkpoints
(counterpart of `qea_ocr_tpu/utils/io.py`, reference `utils.py:191-231` and
the checkpoints of `train_nn_patch.py:440-459`).

A checkpoint is a `torch.save` file holding the model's bare
reference-schema `state_dict` (the names `tools/convert.py` and the JAX
package's `tools/export_torch.py` / `tools/import_torch.py` use, so
checkpoints interchange with the JAX package) and, in a second file beside
it with the suffix `.optim`, the optimizer's `state_dict`.
Every `torch.load` here passes `weights_only=True` explicitly. The PNG
writer needs no imaging library: 8-bit grayscale PNG is a zlib stream with
three chunks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass
class ExpDirs:
    """Experiment directory layout parity: ckpts/, cers/, tracked_labels/,
    selected_samples/, img_out/."""
    base: str

    @property
    def ckpts(self): return os.path.join(self.base, "ckpts")
    @property
    def cers(self): return os.path.join(self.base, "cers")
    @property
    def tracked_labels(self): return os.path.join(self.base, "tracked_labels")
    @property
    def selected_samples(self): return os.path.join(self.base, "selected_samples")
    @property
    def img_out(self): return os.path.join(self.base, "img_out")

    def create(self) -> "ExpDirs":
        for d in (self.base, self.ckpts, self.cers, self.tracked_labels,
                  self.selected_samples, self.img_out):
            os.makedirs(d, exist_ok=True)
        return self


def save_json(obj: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def resolve_side_shard(path: str, process_index: int) -> str:
    """Resolve a side-state JSON path to this process's per-host shard.

    Multi-process trainers shard label-history/selection/CER side-state per
    host with a ``.pN`` suffix before the extension (``tracked_labels.p1.json``
    — `train.budget.BudgetTrainer._save_side_jsons`). Resume accepts the
    unsuffixed name on every worker and prefers the worker's own shard when
    one exists, so a pod restart uses one flag value across hosts. Falls back
    to ``path`` verbatim (single-process runs, or a shard recorded for a
    different topology).
    """
    base, ext = os.path.splitext(path)
    shard = f"{base}.p{process_index}{ext}"
    return shard if os.path.exists(shard) else path


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_image_png(img: np.ndarray, path: str) -> None:
    """Save a (H, W) or (1, H, W) image as an 8-bit grayscale PNG: float in
    [0, 1] (clipped, truncated to uint8 as the JAX package does) or uint8."""
    img = np.asarray(img)
    if img.ndim == 3:
        img = img[0]
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    h, w = img.shape
    # every scanline is preceded by its filter type, 0 = none
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0,
                                                  0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8,
                    pad: int = 2) -> None:
    """Tile a batch (B, 1, H, W) or (B, H, W) into a grid PNG (reference
    `save_img` / torchvision make_grid analogue, `utils.py:43-46`)."""
    images = np.asarray(images)
    if images.ndim == 4:
        images = images[:, 0]
    B, H, W = images.shape
    ncol = min(nrow, B)
    nr = (B + ncol - 1) // ncol
    canvas = np.ones((nr * (H + pad) + pad, ncol * (W + pad) + pad), np.float32)
    for i in range(B):
        r, c = divmod(i, ncol)
        y = pad + r * (H + pad)
        x = pad + c * (W + pad)
        canvas[y:y + H, x:x + W] = images[i]
    save_image_png(canvas, path)


# ---------------------------------------------------------------- checkpoints
OPTIM_SUFFIX = ".optim"


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, model: torch.nn.Module | dict,
                    optimizer: torch.optim.Optimizer | dict | None = None
                    ) -> None:
    """Write `model`'s state_dict to `path` and, if given, `optimizer`'s to
    `path + ".optim"`, both as CPU tensors. Either may be given as its
    state_dict already (one gathered whole from shards,
    `parallel.tp.state_dict_whole`)."""
    sd = model if isinstance(model, dict) else model.state_dict()
    torch.save(_cpu(dict(sd)), path)
    if optimizer is not None:
        osd = optimizer if isinstance(optimizer, dict) \
            else optimizer.state_dict()
        torch.save(_cpu(osd), path + OPTIM_SUFFIX)


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None) -> None:
    """Load the state_dict at `path` into `model`, in place (`strict=True`):
    one written by `save_checkpoint`, or by the JAX package's
    `tools/export_torch.py`.

    Without `optimizer` only parameters and batch statistics are restored
    and the optimizer stays fresh: parity with the reference's
    `torch.load(model)` warm starts. Restoring a converged run's Adam
    moments into a new training phase makes the first steps explosive (stale
    tiny second moments), so that happens only on request, through the
    `--optim_*_path` flags: pass the optimizer, and `path + ".optim"` must
    exist."""
    model.load_state_dict(
        torch.load(path, map_location="cpu", weights_only=True), strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(torch.load(
            path + OPTIM_SUFFIX, map_location="cpu", weights_only=True))
