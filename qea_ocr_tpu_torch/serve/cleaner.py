"""Serving path: batched document cleaning with a trained UNet (counterpart
of `qea_ocr_tpu/serve/cleaner.py`).

Documents of any size are fitted into one fixed processing canvas (white
padding; an aspect-preserving shrink when larger, the geometry
`PatchDocuments` uses), cleaned in fixed-size batches, and cropped back.
The host packs a batch's float32 documents end to end into a staging
buffer (page-locked on CUDA) and uploads that packed content in one copy;
the device quantises it to uint8 and places each document on a white
canvas; the cleaned canvases come back as uint8. `clean_dir` keeps one
batch in flight while the previous one is written, since CUDA work is
queued asynchronously: so the cleaner packs into two staging buffers in
turn, and waits for a buffer's last upload before it writes that buffer
again.

Weights come from a reference-schema state_dict: a checkpoint of the port's
trainers, the file `qea_ocr_tpu.tools.export_torch.export_prep` writes, or a
reference `Prep_model_*` pickle converted by the port's
`tools/import_torch.py`.

Data-parallel serving (`data_parallel=True`, JAX `serve/cleaner.py:63-85`),
one process a GPU under a `torch.distributed` group: the batch size rounds
up to a multiple of the world size, and rank r cleans rows [r*B/w,
(r+1)*B/w) of every global batch. `clean_dir` writes each rank's own files
(together the single-process run's set, byte for byte); `clean_arrays`
gathers every rank's rows, so each rank returns the whole list.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from qea_ocr_tpu_torch import config as C
from qea_ocr_tpu_torch.data.datasets import find_images, load_gray
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.parallel.multihost import (
    all_gather_objects, process_shard, process_sum, rank_device)
from qea_ocr_tpu_torch.tools.convert import load_state_dict_file
from qea_ocr_tpu_torch.utils.device import resolve_device
from qea_ocr_tpu_torch.utils.metrics import span


@dataclasses.dataclass
class _Geometry:
    """How an input was fitted into the fixed processing shape."""
    top: int
    left: int
    h: int          # content height inside the canvas (possibly shrunk)
    w: int


def _fit(img: np.ndarray, h: int, w: int) -> Tuple[np.ndarray, _Geometry]:
    """`img` (H, W) float [0, 1] as it goes into a white (h, w) canvas, and
    its place there, centred: shrunk aspect-preserving (Pillow's
    `thumbnail`) when it does not fit (`data.datasets.pad_white`'s
    geometry), else `img` itself. Pillow is imported only for a shrink."""
    ih, iw = img.shape
    if ih > h or iw > w:
        from PIL import Image
        pil = Image.fromarray((np.clip(np.asarray(img, np.float32), 0, 1)
                               * 255).astype(np.uint8))
        pil.thumbnail((w, h))
        img = np.asarray(pil, np.float32) / 255.0
        ih, iw = img.shape
    return img, _Geometry((h - ih) // 2, (w - iw) // 2, ih, iw)


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
                 unet_features: int = 32, data_parallel: bool = False):
        if (prep_path is None) == (state_dict is None):
            raise ValueError("give exactly one of prep_path and state_dict")
        if state_dict is None:
            state_dict = load_state_dict_file(prep_path)
        self.device = resolve_device(rank_device(device))
        self.doc_size = tuple(doc_size)
        self.batch_size = int(batch_size)
        self._rank, self._world = process_shard() if data_parallel else (0, 1)
        # every rank always has rows: tail batches are white-padded anyway
        self.batch_size = -(-self.batch_size // self._world) * self._world
        self._local = self.batch_size // self._world
        self.model = UNet(init_features=unet_features)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        # a batch's packed documents fill at most this rank's rows of
        # canvases; two staging buffers, used in turn, with the event of
        # each one's last upload (None: nothing to wait for)
        pixels = self._local * self.doc_size[0] * self.doc_size[1]
        self._staging = [torch.empty(pixels, dtype=torch.float32,
                                     pin_memory=self.device.type == "cuda")
                         for _ in range(2)]
        self._uploaded: List[Optional[torch.cuda.Event]] = [None, None]
        self._turn = 0
        self._canvas = torch.empty((self._local, 1, *self.doc_size),
                                   dtype=torch.uint8, device=self.device)

    @torch.no_grad()
    def _forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 1, H, W) uint8 on the device -> cleaned uint8, same shape."""
        out = self.model(images.float() / 255.0)
        return torch.round(out * 255.0).clamp(0, 255).to(torch.uint8)

    @torch.no_grad()
    def _dispatch(self, docs: Sequence[np.ndarray]
                  ) -> Tuple[torch.Tensor, List[_Geometry]]:
        """Queue the cleaning of at most this rank's rows of documents
        ((H, W) float [0, 1]).

        The host fits each document and packs its float32 content end to
        end into the turn's staging buffer; the packed content goes up in
        one copy. The two buffers take turns, and a buffer is written only
        after its last upload has ended, since `clean_dir` packs a batch
        while the previous one may still be uploading. The device quantises
        the content (round half to even of x * 255, clamped to [0, 255]) and
        writes each document into its window of a uint8 canvas filled with
        white; rows past the documents stay white. Returns the first
        len(docs) cleaned uint8 canvases, still on the device (the caller
        downloads them as uint8), and each document's geometry."""
        H, W = self.doc_size
        k, self._turn = self._turn, 1 - self._turn
        staging = self._staging[k]
        with span("fit"):
            if self._uploaded[k] is not None:
                self._uploaded[k].synchronize()
            host = staging.numpy()
            geoms, at = [], [0]
            for img in docs:
                content, g = _fit(np.asarray(img), H, W)
                n = g.h * g.w
                host[at[-1]:at[-1] + n].reshape(g.h, g.w)[...] = content
                geoms.append(g)
                at.append(at[-1] + n)
        with span("upload"):
            packed = staging[:at[-1]].to(self.device, non_blocking=True)
            if self.device.type == "cuda":
                self._uploaded[k] = torch.cuda.Event()
                self._uploaded[k].record(
                    torch.cuda.current_stream(self.device))
        with span("quantise"):
            levels = torch.round(packed * 255.0).clamp_(0, 255).to(
                torch.uint8)
            canvas = self._canvas.fill_(255)
            for i, g in enumerate(geoms):
                canvas[i, 0, g.top:g.top + g.h, g.left:g.left + g.w] = (
                    levels[at[i]:at[i + 1]].view(g.h, g.w))
        return self._forward(canvas)[:len(docs)], geoms

    def _my_rows(self, n: int) -> slice:
        """This rank's rows of a global batch of `n` documents."""
        lo = min(n, self._rank * self._local)
        return slice(lo, min(n, lo + self._local))

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
        it = iter(images)
        with span("clean"):
            while batch := list(itertools.islice(it, self.batch_size)):
                # this rank's rows; with more than one rank, every rank's
                # crops are gathered in rank order
                dev, geoms = self._dispatch(batch[self._my_rows(len(batch))])
                with span("download"):
                    cleaned = dev.cpu().numpy()
                with span("crop"):
                    crops = self._crop(cleaned, geoms)
                if self._world == 1:
                    out.extend(crops)
                else:
                    for part in all_gather_objects(crops):
                        out.extend(part)
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
        size = self.batch_size
        if self._world > 1:
            # this rank's share of every global batch
            paths = [p for i in range(0, len(paths), size)
                     for p in paths[i:i + size][self._my_rows(
                         len(paths[i:i + size]))]]
            size = self._local
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
            for i in range(0, len(paths), size):
                chunk = paths[i:i + size]
                dev, geoms = self._dispatch([load_gray(p) for p in chunk])
                if pending is not None:
                    n_done += finish(pending)
                pending = (dev, geoms, chunk)
            if pending is not None:
                n_done += finish(pending)

        if self._world > 1:
            n_done = int(process_sum([n_done])[0])
            if ocr is not None:
                transcripts = {k: v for part in all_gather_objects(
                    transcripts) for k, v in part.items()}
        if ocr is not None and transcripts_path and self._rank == 0:
            with open(transcripts_path, "w") as f:
                json.dump(transcripts, f, indent=1)
        result = {"num_documents": n_done, "output_dir": output_dir,
                  "transcripts": transcripts_path if ocr is not None else None}
        if ocr is not None:
            result["transcriptions"] = transcripts
        return result
