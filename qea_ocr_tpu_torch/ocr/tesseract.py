"""Tesseract black-box backend (gated on `tesserocr` availability).

Counterpart of reference `ocr_helper/tess_helper.py:10-44`: persistent
PyTessBaseAPI handles — PSM SINGLE_LINE + OEM LSTM_ONLY for text strips,
PSM SINGLE_BLOCK for whole documents.

Batched difference: recognition fans out over a thread pool (tesserocr
releases the GIL inside Recognize), one API handle per worker, so host OCR
overlaps with device compute instead of serializing a per-image Python loop.

The port's own copy of `qea_ocr_tpu/ocr/tesseract.py`: the port imports
nothing of the JAX package, and `tests/test_torch_ocr_backends.py` holds the
copy equal to its original.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np

from qea_ocr_tpu_torch.ocr.base import OcrBackend

try:
    import tesserocr
    from PIL import Image
    HAVE_TESSEROCR = True
except ImportError:  # pragma: no cover - environment without tesseract
    HAVE_TESSEROCR = False


class TesseractBackend(OcrBackend):
    def __init__(self, num_threads: int = 4, tessdata_path: str = "", **kwargs):
        if not HAVE_TESSEROCR:
            raise ImportError(
                "tesserocr is not available in this environment; use the "
                "'Fake' backend for hermetic runs."
            )
        super().__init__(**kwargs)
        self.num_threads = num_threads
        self._tessdata_path = tessdata_path
        self._local = threading.local()
        self._pool = ThreadPoolExecutor(max_workers=num_threads)
        self._block_api = tesserocr.PyTessBaseAPI(
            lang="eng", psm=tesserocr.PSM.SINGLE_BLOCK, path=tessdata_path
        )

    def _line_api(self):
        api = getattr(self._local, "api", None)
        if api is None:
            api = tesserocr.PyTessBaseAPI(
                lang="eng",
                psm=tesserocr.PSM.SINGLE_LINE,
                path=self._tessdata_path,
                oem=tesserocr.OEM.LSTM_ONLY,
            )
            self._local.api = api
        return api

    @staticmethod
    def _to_pil(image: np.ndarray) -> "Image.Image":
        arr = (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8)
        return Image.fromarray(arr, mode="L")

    def _recognize(self, image: np.ndarray) -> str:
        api = self._line_api()
        api.SetImage(self._to_pil(image))
        return api.GetUTF8Text()

    def _recognize_batch(self, images: np.ndarray) -> List[str]:
        """Thread-pooled recognition (normalization/accounting stay in the
        base class get_labels)."""
        return list(self._pool.map(
            self._recognize, [images[i] for i in range(images.shape[0])]))

    def get_string(self, image: np.ndarray) -> List[str]:
        image = np.asarray(image)
        if image.ndim == 3:
            image = image[0]
        self._block_api.SetImage(self._to_pil(image))
        from qea_ocr_tpu_torch.utils.charmap import get_ununicode
        return get_ununicode(self._block_api.GetUTF8Text().strip()).split()
