"""Host-side asynchronous OCR query engine (the port's own copy of
`qea_ocr_tpu/ocr/engine.py`, numpy only).

The reference calls the black-box OCR synchronously inside its training loop
(`train_nn_patch.py:281,290`), serializing device compute behind host OCR.
Here the boundary is explicit: a worker pool OCRs batches off-thread and
returns *tokenized, fixed-shape int arrays* ready to ship to device, so the
train loop can overlap step k's device work with step k's OCR
(double-buffered pipelining) or run synchronously for exact reference parity.

Also owns the query-budget accounting the reference scatters across trainers
(`total_train_bb_calls`/`epoch_bb_calls`, `train_nn_patch.py:298-299`) and a
latency histogram.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List

import numpy as np

from qea_ocr_tpu_torch.ocr.base import OcrBackend
from qea_ocr_tpu_torch.utils.charmap import CharMap


@dataclasses.dataclass
class OcrResult:
    """Tokenized OCR output for one submitted batch."""
    texts: List[str]
    labels: np.ndarray        # (B, max_len) int32, pad-filled
    lengths: np.ndarray       # (B,) int32
    latency_s: float
    tag: object = None


class OcrQueryEngine:
    """Async facade over an `OcrBackend` with budget accounting."""

    def __init__(
        self,
        backend: OcrBackend,
        charmap: CharMap | None = None,
        num_workers: int = 1,
    ):
        self.backend = backend
        self.charmap = charmap or CharMap.default()
        self._pool = ThreadPoolExecutor(max_workers=num_workers)
        self.total_calls = 0
        self.epoch_calls = 0
        self.latencies: List[float] = []

    # ------------------------------------------------------------ budget
    def reset_epoch(self) -> None:
        self.epoch_calls = 0

    @property
    def count_calls(self) -> int:
        """Backend-level call count (reference `count_calls` parity)."""
        return self.backend.count_calls

    def latency_histogram(self, bins: int = 10):
        if not self.latencies:
            return np.zeros(bins), np.linspace(0, 1, bins + 1)
        return np.histogram(np.asarray(self.latencies), bins=bins)

    # ------------------------------------------------------------ queries
    def _run(self, images: np.ndarray, tag: object) -> OcrResult:
        t0 = time.perf_counter()
        texts = self.backend.get_labels(images)
        latency = time.perf_counter() - t0
        cleaned = [self.charmap.clean(t) for t in texts]
        labels, lengths = self.charmap.encode(cleaned)
        self.latencies.append(latency)
        return OcrResult(cleaned, labels, lengths, latency, tag)

    def query(self, images: np.ndarray, tag: object = None) -> OcrResult:
        """Synchronous OCR of a batch (reference-parity path). Counts budget."""
        images = np.asarray(images)
        n = images.shape[0]
        self.total_calls += n
        self.epoch_calls += n
        return self._run(images, tag)

    def submit(self, images: np.ndarray, tag: object = None) -> "Future[OcrResult]":
        """Async OCR of a batch; budget is counted at submit time."""
        images = np.asarray(images)
        n = images.shape[0]
        self.total_calls += n
        self.epoch_calls += n
        return self._pool.submit(self._run, images, tag)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)
