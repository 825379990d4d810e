"""EasyOCR black-box backend (gated on `easyocr` availability).

Counterpart of reference `ocr_helper/eocr_helper.py:11-52`: paragraph-mode
readtext with the reference's very large merge thresholds so each strip
yields at most one string.

The port's own copy of `qea_ocr_tpu/ocr/easyocr_backend.py`: the port
imports nothing of the JAX package, and `tests/test_torch_ocr_backends.py`
holds the copy equal to its original.
"""

from __future__ import annotations

import numpy as np

from qea_ocr_tpu_torch.ocr.base import OcrBackend

try:
    import easyocr
    HAVE_EASYOCR = True
except ImportError:  # pragma: no cover
    HAVE_EASYOCR = False


class EasyOcrBackend(OcrBackend):
    def __init__(self, gpu: bool = False, **kwargs):
        if not HAVE_EASYOCR:
            raise ImportError(
                "easyocr is not available in this environment; use the "
                "'Fake' backend for hermetic runs."
            )
        super().__init__(**kwargs)
        self.reader = easyocr.Reader(["en"], gpu=gpu)

    def _recognize(self, image: np.ndarray) -> str:
        arr = (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8)
        result = self.reader.readtext(
            arr, detail=0, width_ths=35.0, height_ths=35.0,
            ycenter_ths=35.0, paragraph=True,
        )
        return result[0] if result else ""

    def get_string(self, image: np.ndarray):
        from qea_ocr_tpu_torch.utils.charmap import get_ununicode
        image = np.asarray(image)
        if image.ndim == 3:
            image = image[0]
        arr = (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8)
        return [get_ununicode(s) for s in self.reader.readtext(arr, detail=0)]
