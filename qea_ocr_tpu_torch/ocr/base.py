"""Black-box OCR backend protocol.

Counterpart of the reference `ocr_helper/` package: every backend exposes
`get_labels(images) -> List[str]` plus `count_calls` accounting
(`ocr_helper/tess_helper.py:18-37`). Backends receive host numpy arrays —
the black-box boundary is explicitly host-side; devices never block on OCR.

Train-mode label normalization parity (`tess_helper.py:26-35`):
empty -> EMPTY_CHAR; unicode folded into the charset; labels longer than
max_char_len collapse to EMPTY_CHAR. `is_eval=True` skips normalization.

The port's own copy of `qea_ocr_tpu/ocr/base.py` (numpy only): the port imports
nothing of the JAX package, and `tests/test_torch_host_copies.py` holds
the copy equal to its original.
"""

from __future__ import annotations

import abc
import threading
from typing import List, Sequence

import numpy as np

from qea_ocr_tpu_torch.config import EMPTY_CHAR, MAX_CHAR_LEN
from qea_ocr_tpu_torch.utils.charmap import get_ununicode


class OcrBackend(abc.ABC):
    """Abstract black-box OCR engine."""

    def __init__(self, empty_char: str = EMPTY_CHAR, is_eval: bool = False):
        self.empty_char = empty_char
        self.is_eval = is_eval
        self.count_calls = 0
        # get_labels may be called concurrently (threaded dataset fetch,
        # async OCR engine) — budget accounting must not drop increments.
        self._count_lock = threading.Lock()

    def _add_calls(self, n: int) -> None:
        with self._count_lock:
            self.count_calls += n

    @abc.abstractmethod
    def _recognize(self, image: np.ndarray) -> str:
        """OCR a single (H, W) float image in [0, 1]. Returns raw text."""

    def _recognize_batch(self, images: np.ndarray) -> List[str]:
        """Raw recognition of a (B, H, W) stack; subclasses override to
        batch/parallelize (normalization and accounting stay in get_labels
        so they exist exactly once)."""
        return [self._recognize(images[i]) for i in range(images.shape[0])]

    def get_labels(self, images: np.ndarray | Sequence[np.ndarray]) -> List[str]:
        """OCR a batch. images: (B, H, W) or (B, 1, H, W) float [0,1]."""
        images = np.asarray(images)
        if images.ndim == 4:
            images = images[:, 0]
        labels = []
        for raw in self._recognize_batch(images):
            label = raw.strip()
            if label == "":
                label = self.empty_char
            if not self.is_eval:
                label = get_ununicode(label)
                if len(label) > MAX_CHAR_LEN:
                    label = self.empty_char
            labels.append(label)
        self._add_calls(len(labels))
        return labels

    def get_string(self, image: np.ndarray) -> List[str]:
        """Whole-document OCR -> list of words (reference `get_string`)."""
        image = np.asarray(image)
        if image.ndim == 3:
            image = image[0]
        return get_ununicode(self._recognize(image).strip()).split()


def get_ocr_helper(name: str | None, is_eval: bool = False) -> OcrBackend | None:
    """Factory, parity with reference `utils.py:180-188` plus the hermetic
    'Fake' backend. Unknown / None -> None."""
    if name == "Tesseract":
        from qea_ocr_tpu_torch.ocr.tesseract import TesseractBackend
        return TesseractBackend(is_eval=is_eval)
    if name == "EasyOCR":
        from qea_ocr_tpu_torch.ocr.easyocr_backend import EasyOcrBackend
        return EasyOcrBackend(is_eval=is_eval)
    if name == "gvision":
        from qea_ocr_tpu_torch.ocr.gvision import GVisionBackend
        return GVisionBackend(is_eval=is_eval)
    if name == "Fake":
        from qea_ocr_tpu_torch.ocr.fake import FakeOcrBackend
        return FakeOcrBackend(is_eval=is_eval)
    return None
