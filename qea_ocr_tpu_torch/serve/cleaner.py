"""Serving path: batched document cleaning with a trained UNet (counterpart
of `qea_ocr_tpu/serve/cleaner.py`).

Documents of any size are fitted into one fixed processing canvas (white
padding; an aspect-preserving shrink when larger, the geometry
`PatchDocuments` uses), cleaned in fixed-size batches, and cropped back.
Both host-device transfers are uint8: normalisation and quantisation
happen on the device. `clean_dir` keeps one batch in flight while the
previous one is written, since CUDA work is queued asynchronously.

Weights come from a reference-schema state_dict: a checkpoint of the port's
trainers, the file `qea_ocr_tpu.tools.export_torch.export_prep` writes, or a
reference `Prep_model_*` pickle converted by the port's
`tools/import_torch.py`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from qea_ocr_tpu_torch import config as C
from qea_ocr_tpu_torch.data.datasets import find_images, load_gray
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.tools.convert import load_state_dict_file
from qea_ocr_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class _Geometry:
    """How an input was fitted into the fixed processing shape."""
    top: int
    left: int
    h: int          # content height inside the canvas (possibly shrunk)
    w: int


def pad_white(img: np.ndarray, h: int, w: int
              ) -> Tuple[np.ndarray, _Geometry]:
    """Centre `img` (H, W) float [0, 1] on a white (h, w) canvas, first
    shrinking it aspect-preserving (Pillow's `thumbnail`) when it does not
    fit (`data.datasets.pad_white`'s geometry). Pillow is
    imported only for a shrink."""
    ih, iw = img.shape
    if ih > h or iw > w:
        from PIL import Image
        pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
        pil.thumbnail((w, h))
        img = np.asarray(pil, np.float32) / 255.0
        ih, iw = img.shape
    top = (h - ih) // 2
    left = (w - iw) // 2
    out = np.ones((h, w), np.float32)
    out[top:top + ih, left:left + iw] = img
    return out, _Geometry(top, left, ih, iw)


def save_png(img: np.ndarray, path: str) -> None:
    """Write an (H, W) uint8 image as a grayscale PNG."""
    from PIL import Image
    Image.fromarray(img, "L").save(path)


class DocumentCleaner:
    """Fixed-shape batched UNet inference for document cleaning.

    Exactly one of `prep_path` (a state_dict file) and `state_dict` gives
    the weights."""

    def __init__(self, prep_path: Optional[str] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None, *,
                 device: str | torch.device, batch_size: int = 8,
                 doc_size: Tuple[int, int] = C.DOC_SIZE,
                 unet_features: int = 32):
        if (prep_path is None) == (state_dict is None):
            raise ValueError("give exactly one of prep_path and state_dict")
        if state_dict is None:
            state_dict = load_state_dict_file(prep_path)
        self.device = resolve_device(device)
        self.doc_size = tuple(doc_size)
        self.batch_size = int(batch_size)
        self.model = UNet(init_features=unet_features)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def _forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 1, H, W) uint8 on the device -> cleaned uint8, same shape."""
        out = self.model(images.float() / 255.0)
        return torch.round(out * 255.0).clamp(0, 255).to(torch.uint8)

    def _fit(self, img: np.ndarray) -> Tuple[np.ndarray, _Geometry]:
        return pad_white(np.asarray(img, np.float32), *self.doc_size)

    def _batches(self, it: Iterable[np.ndarray]):
        batch, geoms = [], []
        for img in it:
            canvas, geom = self._fit(img)
            batch.append(canvas)
            geoms.append(geom)
            if len(batch) == self.batch_size:
                yield batch, geoms
                batch, geoms = [], []
        if batch:
            yield batch, geoms

    def _dispatch(self, batch: List[np.ndarray]) -> torch.Tensor:
        """Quantise the float canvases to uint8 on the host, pad the batch
        to the fixed batch size with white, and queue the forward. Returns
        the first len(batch) cleaned documents, still on the device."""
        n = len(batch)
        arr = np.round(np.stack(batch)[:, None] * 255.0).clip(0, 255) \
                .astype(np.uint8)                         # (n, 1, H, W)
        if n < self.batch_size:
            arr = np.concatenate(
                [arr, np.full((self.batch_size - n, 1, *self.doc_size),
                              255, np.uint8)])
        images = torch.from_numpy(arr).to(self.device)
        return self._forward(images)[:n]

    @staticmethod
    def _crop(cleaned: np.ndarray, geoms: List[_Geometry]) -> List[np.ndarray]:
        return [cleaned[i, 0, g.top:g.top + g.h, g.left:g.left + g.w]
                for i, g in enumerate(geoms)]

    def clean_arrays_uint8(self, images: Sequence[np.ndarray]
                           ) -> List[np.ndarray]:
        """Clean (H, W) float [0, 1] grayscale images; returns the cleaned
        content regions as uint8 at processing resolution (shrunk inputs
        stay shrunk)."""
        out: List[np.ndarray] = []
        for batch, geoms in self._batches(iter(images)):
            cleaned = self._dispatch(batch).cpu().numpy()
            out.extend(self._crop(cleaned, geoms))
        return out

    def clean_arrays(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        """`clean_arrays_uint8` scaled back to float [0, 1]."""
        return [c.astype(np.float32) / 255.0
                for c in self.clean_arrays_uint8(images)]

    def clean_dir(self, input_dir: str, output_dir: str, *, ocr=None,
                  transcripts_path: Optional[str] = None,
                  exts=("png", "jpg", "jpeg")) -> dict:
        """Clean every image under `input_dir` into `output_dir`, named by
        the input-relative path with '/' flattened to '__'. With an OCR
        backend each cleaned document is transcribed, keyed by its
        input-relative path; the transcriptions are returned and, given
        `transcripts_path`, written there as JSON."""
        paths = find_images(input_dir, exts=exts)
        os.makedirs(output_dir, exist_ok=True)
        transcripts: dict = {}
        n_done = 0

        def write(path: str, img: np.ndarray) -> None:
            rel = os.path.relpath(path, input_dir)
            stem = os.path.splitext(rel)[0].replace(os.sep, "__")
            save_png(img, os.path.join(output_dir, stem + ".png"))
            if ocr is not None:
                transcripts[rel] = ocr.get_string(
                    img.astype(np.float32) / 255.0)

        def finish(pending) -> int:
            dev, geoms, chunk = pending
            cleaned = self._crop(dev.cpu().numpy(), geoms)
            list(pool.map(write, chunk, cleaned))
            return len(cleaned)

        pending = None  # (device result, geometries, paths) awaiting fetch
        with ThreadPoolExecutor(max_workers=4) as pool:
            for i in range(0, len(paths), self.batch_size):
                chunk = paths[i:i + self.batch_size]
                fitted = [self._fit(load_gray(p)) for p in chunk]
                dev = self._dispatch([c for c, _ in fitted])
                if pending is not None:
                    n_done += finish(pending)
                pending = (dev, [g for _, g in fitted], chunk)
            if pending is not None:
                n_done += finish(pending)

        if ocr is not None and transcripts_path:
            with open(transcripts_path, "w") as f:
                json.dump(transcripts, f, indent=1)
        result = {"num_documents": n_done, "output_dir": output_dir,
                  "transcripts": transcripts_path if ocr is not None else None}
        if ocr is not None:
            result["transcriptions"] = transcripts
        return result
