"""Google Cloud Vision black-box backend (gated; mock replay supported).

Counterpart of reference `ocr_helper/gcloud_helper.py:31-137`:
  * `text_detection` per strip with charset filtering;
  * failure counter that aborts after `max_exceptions` consecutive errors;
  * `mock_response` mode replays a canned annotation so tests and offline
    runs never hit the network (the reference reads a JSON fixture,
    `gcloud_helper.py:114-117`);
  * `get_labels_fullimage` returning word bboxes for a whole document.

The port's own copy of `qea_ocr_tpu/ocr/gvision.py`: the port imports
nothing of the JAX package, and `tests/test_torch_ocr_backends.py` holds the
copy equal to its original.
"""

from __future__ import annotations

import io
from typing import List, Tuple

import numpy as np

from qea_ocr_tpu_torch.config import CHAR_SET
from qea_ocr_tpu_torch.ocr.base import OcrBackend

try:
    from google.cloud import vision
    HAVE_GVISION = True
except ImportError:  # pragma: no cover
    HAVE_GVISION = False


_CHARSET = set(CHAR_SET)


class GVisionBackend(OcrBackend):
    def __init__(self, mock_response: bool = False, max_exceptions: int = 20,
                 mock_text: str = "MOCK", **kwargs):
        super().__init__(**kwargs)
        self.mock_response = mock_response
        self.max_exceptions = max_exceptions
        self.exception_count = 0
        self.mock_text = mock_text
        if not mock_response:
            if not HAVE_GVISION:
                raise ImportError(
                    "google-cloud-vision is not available; construct with "
                    "mock_response=True or use the 'Fake' backend."
                )
            self.client = vision.ImageAnnotatorClient()

    @staticmethod
    def _png_bytes(image: np.ndarray) -> bytes:
        from PIL import Image
        arr = (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr, mode="L").save(buf, format="PNG")
        return buf.getvalue()

    def _filter_charset(self, text: str) -> str:
        return "".join(c for c in text if c in _CHARSET)

    def _recognize(self, image: np.ndarray) -> str:
        if self.mock_response:
            return self.mock_text
        try:
            img = vision.Image(content=self._png_bytes(image))
            response = self.client.text_detection(image=img)
            self.exception_count = 0
            anns = response.text_annotations
            if not anns:
                return ""
            text = anns[0].description.replace("\n", " ").strip()
            return self._filter_charset(text)
        except Exception:
            self.exception_count += 1
            if self.exception_count >= self.max_exceptions:
                raise RuntimeError(
                    f"GVision failed {self.max_exceptions} consecutive times"
                )
            return ""

    def get_labels_fullimage(
        self, image: np.ndarray
    ) -> List[Tuple[str, Tuple[int, int, int, int]]]:
        """Whole-document OCR -> [(word, (x_min, y_min, x_max, y_max)), ...].

        Mock mode emits a single synthetic word box.
        """
        if self.mock_response:
            return [(self.mock_text, (0, 0, 127, 31))]
        img = vision.Image(content=self._png_bytes(np.asarray(image)))
        response = self.client.text_detection(image=img)
        out = []
        for ann in response.text_annotations[1:]:  # [0] is the full text
            xs = [v.x for v in ann.bounding_poly.vertices]
            ys = [v.y for v in ann.bounding_poly.vertices]
            word = self._filter_charset(ann.description)
            out.append((word, (min(xs), min(ys), max(xs), max(ys))))
        return out
