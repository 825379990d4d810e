"""The port's gated OCR back ends (`qea_ocr_tpu_torch/ocr/tesseract.py`,
`ocr/easyocr_backend.py`, `ocr/gvision.py`) on its own stub engines
(`ocr/stub_engines.py`), on the CPU: the cases of the JAX package's
`tests/test_ocr_backends.py` against the port (thread-local handle pooling,
PSM/OEM configuration, readtext arguments, label normalisation, concurrent
budget accounting), both replays of the committed stub-contract fixtures in
`tests/fixtures/ocr_golden/`, and the same seeded strips through the JAX
package's back ends and the port's, which must read the same labels.

Without an engine each back end raises `ImportError` at construction, as in
the JAX package; the GVision mock needs none.
"""

import importlib
import os
import sys
import threading

import numpy as np
import pytest

import qea_ocr_tpu.ocr.easyocr_backend as j_eocr
import qea_ocr_tpu.ocr.tesseract as j_tess
import qea_ocr_tpu_torch.ocr.easyocr_backend as t_eocr
import qea_ocr_tpu_torch.ocr.tesseract as t_tess
from qea_ocr_tpu.ocr import stub_engines as j_stubs
from qea_ocr_tpu.ocr.gvision import GVisionBackend as JGVision
from qea_ocr_tpu_torch.data.synth import make_word_crop, render_text_strip
from qea_ocr_tpu_torch.ocr.gvision import GVisionBackend as TGVision
from qea_ocr_tpu_torch.ocr.stub_engines import (
    StubReader as _StubReader,
    StubTessApi as _StubApi,
    make_stub_easyocr,
    make_stub_tesserocr,
)

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "ocr_golden")


def _strips(texts):
    return np.stack([render_text_strip(t, 32, 128) for t in texts])


def _seeded_strips(seed, n=10):
    rng = np.random.default_rng(seed)
    return np.stack([make_word_crop(rng, None, 32, 128, corruption=dict(
        noise_std=0.04 * (i % 3), shading=0.05, salt_pepper=0.0))[0]
        for i in range(n)])


def _install(monkeypatch, name, stub, *mods):
    monkeypatch.setitem(sys.modules, name, stub)
    for mod in mods:
        importlib.reload(mod)


def _restore(name, *mods):
    """Back to the gated (engine-absent) module state."""
    sys.modules.pop(name, None)
    for mod in mods:
        importlib.reload(mod)


@pytest.fixture
def tess_mod(monkeypatch):
    _install(monkeypatch, "tesserocr", make_stub_tesserocr(), t_tess)
    assert t_tess.HAVE_TESSEROCR
    _StubApi.created.clear()
    yield t_tess
    _restore("tesserocr", t_tess)


class TestTesseractBackend:
    def test_get_labels_reads_clean_strips(self, tess_mod):
        be = tess_mod.TesseractBackend(num_threads=2)
        texts = ["HELLO", "WORLD 42", "TOTAL 9.99"]
        assert be.get_labels(_strips(texts)) == texts
        assert be.count_calls == 3

    def test_line_api_config_and_pooling(self, tess_mod):
        """One SINGLE_LINE+LSTM_ONLY handle per worker thread (plus the
        SINGLE_BLOCK doc handle), reused across batches."""
        be = tess_mod.TesseractBackend(num_threads=3)
        texts = ["A%d" % i for i in range(12)]
        be.get_labels(_strips(texts))
        be.get_labels(_strips(texts))
        line_apis = [k for _, k in _StubApi.created if k.get("psm") == "psm7"]
        block_apis = [k for _, k in _StubApi.created if k.get("psm") == "psm6"]
        assert len(block_apis) == 1
        assert 1 <= len(line_apis) <= 3
        assert all(k.get("oem") == "oem1" for k in line_apis)
        threads = {t for t, k in _StubApi.created if k.get("psm") == "psm7"}
        assert len(threads) == len(line_apis)

    def test_normalization_empty_and_overlong(self, tess_mod):
        be = tess_mod.TesseractBackend(num_threads=2)
        blank = np.ones((1, 32, 128), np.float32)
        assert be.get_labels(blank) == [" "]
        be_eval = tess_mod.TesseractBackend(num_threads=2, is_eval=True)
        assert be_eval.get_labels(blank) == [" "]

    def test_concurrent_budget_accounting(self, tess_mod):
        be = tess_mod.TesseractBackend(num_threads=4)
        strips = _strips(["X1", "X2", "X3", "X4", "X5"])
        n_callers, reps = 6, 4

        def worker():
            for _ in range(reps):
                be.get_labels(strips)

        ts = [threading.Thread(target=worker) for _ in range(n_callers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert be.count_calls == n_callers * reps * len(strips)

    def test_get_string_block_path(self, tess_mod):
        be = tess_mod.TesseractBackend(num_threads=2)
        assert be.get_string(render_text_strip("TOTAL 42", 32, 128)) \
            == ["TOTAL", "42"]

    def test_channel_axis_squeeze(self, tess_mod):
        be = tess_mod.TesseractBackend(num_threads=2)
        assert be.get_labels(_strips(["ABC"])[:, None]) == ["ABC"]


@pytest.fixture
def eocr_mod(monkeypatch):
    _install(monkeypatch, "easyocr", make_stub_easyocr(), t_eocr)
    yield t_eocr
    _restore("easyocr", t_eocr)


class TestEasyOcrBackend:
    def test_get_labels_and_readtext_kwargs(self, eocr_mod):
        be = eocr_mod.EasyOcrBackend()
        assert be.get_labels(_strips(["CASH 12", "ITEM"])) == ["CASH 12",
                                                              "ITEM"]
        kw = _StubReader.last_kwargs
        assert kw == dict(detail=0, width_ths=35.0, height_ths=35.0,
                          ycenter_ths=35.0, paragraph=True)
        assert _StubReader.init_args == (["en"], False)

    def test_empty_result_maps_to_empty_char(self, eocr_mod):
        be = eocr_mod.EasyOcrBackend()
        assert be.get_labels(np.ones((1, 32, 128), np.float32)) == [" "]


def _load_golden(name):
    data = np.load(os.path.join(FIXTURE_DIR, name), allow_pickle=True)
    assert str(data["engine_kind"]) == "stub"
    return data


def test_tesseract_golden_replay(monkeypatch):
    """The committed stub-contract fixture, read byte for byte by the
    port's back end on the port's stub."""
    data = _load_golden("tesseract.npz")
    _install(monkeypatch, "tesserocr", make_stub_tesserocr(), t_tess)
    try:
        be = t_tess.TesseractBackend(num_threads=4)
        assert be.get_labels(data["images"]) \
            == [str(x) for x in data["labels"]]
    finally:
        _restore("tesserocr", t_tess)


def test_easyocr_golden_replay(monkeypatch):
    data = _load_golden("easyocr.npz")
    _install(monkeypatch, "easyocr", make_stub_easyocr(), t_eocr)
    try:
        be = t_eocr.EasyOcrBackend()
        assert be.get_labels(data["images"]) \
            == [str(x) for x in data["labels"]]
    finally:
        _restore("easyocr", t_eocr)


@pytest.mark.parametrize("engine", ["tesserocr", "easyocr"])
def test_same_labels_as_the_jax_back_ends(monkeypatch, engine):
    """Seeded noisy strips through the JAX back end on the JAX stub and the
    port's on the port's stub: the same labels and the same ledger."""
    strips = _seeded_strips(3)
    got = {}
    for side, mod, make in (
            ("jax", j_tess if engine == "tesserocr" else j_eocr,
             j_stubs.make_stub_tesserocr if engine == "tesserocr"
             else j_stubs.make_stub_easyocr),
            ("port", t_tess if engine == "tesserocr" else t_eocr,
             make_stub_tesserocr if engine == "tesserocr"
             else make_stub_easyocr)):
        _install(monkeypatch, engine, make(), mod)
        try:
            be = (mod.TesseractBackend(num_threads=2)
                  if engine == "tesserocr" else mod.EasyOcrBackend())
            got[side] = (be.get_labels(strips), be.count_calls,
                         be.get_string(strips[0]))
        finally:
            _restore(engine, mod)
    assert got["port"] == got["jax"]
    assert any(label.strip() for label in got["port"][0])


def test_missing_engines_raise_at_construction():
    """No engine here: `ImportError` with the JAX package's message."""
    for j_cls, t_cls, kw in ((j_tess.TesseractBackend,
                              t_tess.TesseractBackend, {}),
                             (j_eocr.EasyOcrBackend, t_eocr.EasyOcrBackend,
                              {}),
                             (JGVision, TGVision, dict(mock_response=False))):
        with pytest.raises(ImportError) as want:
            j_cls(**kw)
        with pytest.raises(ImportError) as got:
            t_cls(**kw)
        assert str(got.value) == str(want.value)


def test_gvision_mock():
    """The mock needs no engine: canned text through the label pipeline,
    one canned word box a document, the charset filter as in JAX."""
    strips = _seeded_strips(4, n=3)
    for cls in (JGVision, TGVision):
        be = cls(mock_response=True, mock_text="TOTAL 12")
        assert be.get_labels(strips) == ["TOTAL 12"] * 3
        assert be.count_calls == 3
        assert be.get_labels_fullimage(strips[0]) \
            == [("TOTAL 12", (0, 0, 127, 31))]
        assert be._filter_charset("aéb✓") \
            == JGVision(mock_response=True)._filter_charset("aéb✓")
