"""Behaviorally-faithful stub engine modules for the gated OCR backends.

The real `tesserocr` / `easyocr` engines are not installable in every
environment (they are gated imports in `ocr/tesseract.py` /
`ocr/easyocr_backend.py`, mirroring reference `ocr_helper/tess_helper.py:
10-44`, `ocr_helper/eocr_helper.py:11-52`). These stubs expose the exact
module surface the backends consume — `PyTessBaseAPI`/`PSM`/`OEM`,
`easyocr.Reader.readtext` — and recognize synthetic bitmap-font strips via
the same template matcher `FakeOcrBackend` uses, so the backends' REAL
code paths (thread-local handle pooling, PSM/OEM configuration, PIL
conversion, readtext kwargs, label normalization, concurrent budget
accounting) execute deterministically without the engines.

Consumers: `tests/test_torch_ocr_backends.py` — hermetic executed-code
tests + the replay of the stub-contract fixtures shipped in
`tests/fixtures/ocr_golden/` (recorded by the JAX package's recorder with
its own copy of these stubs).

The stubs live in the package (not under tests/), as in the JAX package;
they import nothing at module scope beyond numpy and are never touched by
production code paths.

The port's own copy of `qea_ocr_tpu/ocr/stub_engines.py`: the port imports
nothing of the JAX package, and `tests/test_torch_ocr_backends.py` holds the
copy equal to its original.
"""

from __future__ import annotations

import sys
import threading
import types

import numpy as np


class StubTessApi:
    """Stand-in for `tesserocr.PyTessBaseAPI`.

    Class-level `created` records (thread_name, ctor_kwargs) per handle so
    tests can assert the backend's thread-local pooling; the `_busy` flag
    flags concurrent reuse of one handle (a real persistent PyTessBaseAPI
    is not thread-safe).
    """

    created = []          # (thread_name, kwargs) per constructed handle
    lock = threading.Lock()

    def __init__(self, **kwargs):
        with StubTessApi.lock:
            StubTessApi.created.append(
                (threading.current_thread().name, dict(kwargs)))
        self.kwargs = kwargs
        self._img = None
        self._owner = threading.get_ident()
        self._busy = False

    def SetImage(self, pil_img):
        # a persistent handle is not thread-safe: flag concurrent reuse
        assert not self._busy, "PyTessBaseAPI handle used concurrently"
        self._img = pil_img

    def GetUTF8Text(self):
        self._busy = True
        try:
            from qea_ocr_tpu_torch.ocr.fake import FakeOcrBackend
            arr = np.asarray(self._img, dtype=np.float32) / 255.0
            return FakeOcrBackend()._recognize(arr) + "\n"
        finally:
            self._busy = False


class StubReader:
    """Stand-in for `easyocr.Reader` (paragraph-mode readtext)."""

    init_args = None
    last_kwargs = None

    def __init__(self, langs, gpu=True):
        StubReader.init_args = (langs, gpu)

    def readtext(self, arr, **kwargs):
        StubReader.last_kwargs = kwargs
        from qea_ocr_tpu_torch.ocr.fake import FakeOcrBackend
        img = np.asarray(arr, dtype=np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        text = FakeOcrBackend()._recognize(img)
        return [text] if text else []


def make_stub_tesserocr() -> types.ModuleType:
    stub = types.ModuleType("tesserocr")
    stub.PyTessBaseAPI = StubTessApi
    stub.PSM = types.SimpleNamespace(SINGLE_LINE="psm7", SINGLE_BLOCK="psm6")
    stub.OEM = types.SimpleNamespace(LSTM_ONLY="oem1")
    return stub


def make_stub_easyocr() -> types.ModuleType:
    stub = types.ModuleType("easyocr")
    stub.Reader = StubReader
    return stub


def install_stub_engines() -> None:
    """Inject both stub engines into `sys.modules` and reload the backend
    modules so their gated imports bind to the stubs. Kept for a recorder
    (the JAX package's `record_ocr_golden.py --stub`); tests prefer monkeypatch-scoped
    installs via `make_stub_*` so the gated state is restored afterwards.
    """
    import importlib

    sys.modules["tesserocr"] = make_stub_tesserocr()
    sys.modules["easyocr"] = make_stub_easyocr()
    import qea_ocr_tpu_torch.ocr.easyocr_backend
    import qea_ocr_tpu_torch.ocr.tesseract
    importlib.reload(qea_ocr_tpu_torch.ocr.tesseract)
    importlib.reload(qea_ocr_tpu_torch.ocr.easyocr_backend)
