"""The port's own copies of the JAX package's numpy-only host modules stay
equal to their originals: the same seeded inputs through both give equal
results. No model runs here."""

import dataclasses

import numpy as np
import pytest

from qea_ocr_tpu import config as j_config
from qea_ocr_tpu.data import pipeline as j_pipeline
from qea_ocr_tpu.data.datasets import PatchDocuments as JPatchDocuments
from qea_ocr_tpu.ocr.base import get_ocr_helper as j_get_ocr_helper
from qea_ocr_tpu.tools import export_torch as j_export
from qea_ocr_tpu.utils.charmap import CharMap as JCharMap
from qea_ocr_tpu_torch import config as t_config
from qea_ocr_tpu_torch.data import pipeline as t_pipeline
from qea_ocr_tpu_torch.data.datasets import PatchDocuments as TPatchDocuments
from qea_ocr_tpu_torch.ocr.base import get_ocr_helper as t_get_ocr_helper
from qea_ocr_tpu_torch.tools import convert as t_convert
from qea_ocr_tpu_torch.utils.charmap import CharMap as TCharMap


def _assert_batches_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def _config():
    names = [n for n in dir(j_config) if n.isupper()]
    assert "CHAR_SET" in names and "DOC_SIZE" in names
    for n in names:
        assert getattr(t_config, n) == getattr(j_config, n), n
    for cls in ("VocabConfig", "ModelConfig", "TrackingConfig",
                "SelectionConfig", "TrainConfig", "MeshConfig"):
        assert dataclasses.asdict(getattr(t_config, cls)()) \
            == dataclasses.asdict(getattr(j_config, cls)()), cls


def _charmap():
    rng = np.random.default_rng(0)
    jc, tc = JCharMap.default(), TCharMap.default()
    assert (jc.vocab_size, jc.pad_id, jc.max_len) \
        == (tc.vocab_size, tc.pad_id, tc.max_len)
    chars = list(j_config.CHAR_SET[1:]) + ["é", "✓", " "]
    words = ["".join(rng.choice(chars, rng.integers(0, 20)))
             for _ in range(50)] + ["", " ", "x" * 150]
    assert [tc.clean(w) for w in words] == [jc.clean(w) for w in words]
    clean = [jc.clean(w) for w in words]
    j_lab, j_len = jc.encode(clean)
    t_lab, t_len = tc.encode(clean)
    np.testing.assert_array_equal(t_lab, j_lab)
    np.testing.assert_array_equal(t_len, j_len)
    assert tc.decode(t_lab, t_len) == jc.decode(j_lab, j_len)


def _documents():
    kw = dict(seed=3, n_strips=5, max_strips=8, doc_size=(96, 256))
    jd, td = JPatchDocuments.synthetic(4, **kw), TPatchDocuments.synthetic(4, **kw)
    assert td.num_strips == jd.num_strips and td.name_to_id == jd.name_to_id
    jb = j_pipeline.collate_docs(jd.samples)
    tb = t_pipeline.collate_docs(td.samples)
    _assert_batches_equal(tb, jb)
    _assert_batches_equal(t_pipeline.pad_docbatch(tb, 6),
                          j_pipeline.pad_docbatch(jb, 6))


def _fake_ocr():
    from qea_ocr_tpu_torch.data.synth import make_word_crop
    rng = np.random.default_rng(5)
    strips = np.stack([make_word_crop(
        rng, None, 32, 128, corruption=dict(
            noise_std=0.1 * (i % 3), shading=0.1, salt_pepper=0.0))[0]
        for i in range(12)])
    j_ocr, t_ocr = j_get_ocr_helper("Fake"), t_get_ocr_helper("Fake")
    got, want = t_ocr.get_labels(strips), j_ocr.get_labels(strips)
    assert got == want and any(len(w.strip()) > 0 for w in want)
    assert t_ocr.count_calls == j_ocr.count_calls == 12
    assert t_ocr.get_string(strips[0]) == j_ocr.get_string(strips[0])
    assert t_get_ocr_helper(None) is None and t_get_ocr_helper("nope") is None


def _ocr_factory():
    """`get_ocr_helper` for every name: the same back end class, or the
    same `ImportError` where the engine is missing (as here for all three
    real engines)."""
    for name in ("Tesseract", "EasyOCR", "gvision", "Fake", None, "nope"):
        for is_eval in (False, True):
            out = []
            for factory in (j_get_ocr_helper, t_get_ocr_helper):
                try:
                    helper = factory(name, is_eval=is_eval)
                except ImportError as e:
                    out.append(("ImportError", str(e)))
                else:
                    out.append((type(helper).__name__,
                                getattr(helper, "is_eval", None)))
            assert out[0] == out[1], (name, out)
            if name == "Fake":
                assert out[1] == ("FakeOcrBackend", is_eval)


def _batch_iterator():
    kw = dict(seed=3, n_strips=5, max_strips=8, doc_size=(96, 256))
    jd, td = JPatchDocuments.synthetic(7, **kw), TPatchDocuments.synthetic(7, **kw)
    for opts in (dict(seed=4, epoch=2), dict(shuffle=False, drop_last=False),
                 dict(seed=1, indices=np.asarray([5, 0, 3, 6]), num_workers=2,
                      prefetch=2)):
        jbs = list(j_pipeline.batch_iterator(jd, 2, j_pipeline.collate_docs,
                                             **opts))
        tbs = list(t_pipeline.batch_iterator(td, 2, t_pipeline.collate_docs,
                                             **opts))
        assert len(tbs) == len(jbs) > 1
        for tb, jb in zip(tbs, jbs):
            _assert_batches_equal(tb, jb)
    _assert_batches_equal(t_pipeline.blank_docbatch(tbs[0], 3),
                          j_pipeline.blank_docbatch(jbs[0], 3))
    assert t_pipeline.default_num_workers() == j_pipeline.default_num_workers()
    for p in range(2):
        jbs = list(j_pipeline.batch_iterator(jd, 4, j_pipeline.collate_docs,
                                             seed=2, host_shard=(p, 2)))
        tbs = list(t_pipeline.batch_iterator(td, 4, t_pipeline.collate_docs,
                                             seed=2, host_shard=(p, 2)))
        assert len(tbs) == len(jbs) == 1
        _assert_batches_equal(tbs[0], jbs[0])

    def boom():
        yield 1
        raise KeyError("producer")
    it = t_pipeline.prefetch_iterator(boom(), depth=1)
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)


def _multihost():
    """`parallel/multihost.py`'s host functions and `resolve_side_shard`."""
    import tempfile
    from pathlib import Path

    from qea_ocr_tpu.parallel import multihost as j_mh
    from qea_ocr_tpu.utils.io import resolve_side_shard as j_resolve
    from qea_ocr_tpu_torch.parallel import multihost as t_mh
    from qea_ocr_tpu_torch.utils.io import resolve_side_shard as t_resolve
    idx = np.random.default_rng(11).permutation(37)
    for pc in (1, 2, 4):
        assert t_mh.local_batch_size(8, pc) == j_mh.local_batch_size(8, pc)
        for p in range(pc):
            np.testing.assert_array_equal(
                t_mh.shard_indices_for_host(idx, 8, p, pc),
                j_mh.shard_indices_for_host(idx, 8, p, pc))
            np.testing.assert_array_equal(t_mh.pinned_subset(idx, p, pc),
                                          j_mh.pinned_subset(idx, p, pc))
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "cers.json")
        (Path(tmp) / "cers.p2.json").write_text("{}")
        for rank in range(4):
            assert t_resolve(path, rank) == j_resolve(path, rank)


def _ocr_engine():
    from qea_ocr_tpu.ocr.engine import OcrQueryEngine as JEngine
    from qea_ocr_tpu_torch.data.synth import make_word_crop
    from qea_ocr_tpu_torch.ocr.engine import OcrQueryEngine as TEngine
    rng = np.random.default_rng(6)
    strips = np.stack([make_word_crop(
        rng, None, 32, 128, corruption=dict(
            noise_std=0.05, shading=0.1, salt_pepper=0.0))[0]
        for _ in range(6)])[:, None]
    j = JEngine(j_get_ocr_helper("Fake"), JCharMap.default())
    t = TEngine(t_get_ocr_helper("Fake"), TCharMap.default())
    for jr, tr in ((j.query(strips), t.query(strips)),
                   (j.submit(strips[:4]).result(),
                    t.submit(strips[:4]).result())):
        assert tr.texts == jr.texts
        np.testing.assert_array_equal(tr.labels, jr.labels)
        np.testing.assert_array_equal(tr.lengths, jr.lengths)
    assert (t.total_calls, t.epoch_calls, t.count_calls) \
        == (j.total_calls, j.epoch_calls, j.count_calls) == (10, 10, 10)
    t.reset_epoch()
    assert t.epoch_calls == 0 and t.total_calls == 10
    assert len(t.latencies) == 2 and t.latency_histogram()[0].sum() == 2
    j.shutdown(), t.shutdown()


def _random_tree(rng, shapes):
    return {k: _random_tree(rng, v) if isinstance(v, dict)
            else rng.normal(size=v).astype(np.float32)
            for k, v in shapes.items()}


def _bn(c):
    return {"scale": (c,), "bias": (c,)}, {"mean": (c,), "var": (c,)}


def _state_dict_unet():
    rng = np.random.default_rng(7)
    f = 2
    chans = dict(enc1=(1, f), enc2=(f, 2 * f), enc3=(2 * f, 4 * f),
                 enc4=(4 * f, 8 * f), bottleneck=(8 * f, 16 * f),
                 dec4=(16 * f, 8 * f), dec3=(8 * f, 4 * f),
                 dec2=(4 * f, 2 * f), dec1=(2 * f, f))
    params, stats = {}, {}
    for name, (cin, c) in chans.items():
        params[name], stats[name] = {}, {}
        for j, ci in enumerate((cin, c)):
            params[name][f"Conv_{j}"] = {"kernel": (3, 3, ci, c)}
            params[name][f"BatchNorm_{j}"], stats[name][f"BatchNorm_{j}"] = _bn(c)
    for lvl, c in ((4, 8 * f), (3, 4 * f), (2, 2 * f), (1, f)):
        params[f"upconv{lvl}"] = {"kernel": (2, 2, 2 * c, c), "bias": (c,)}
    params["Conv_0"] = {"kernel": (1, 1, f, 1), "bias": (1,)}
    v = {"params": _random_tree(rng, params),
         "batch_stats": _random_tree(rng, stats)}
    return t_convert.state_dict_from_unet(v), j_export.state_dict_from_unet(v)


def _state_dict_crnn():
    rng = np.random.default_rng(8)
    H, V = 4, 11
    feats = (3, 4, 5, 5, 6, 6, 6)
    conv, cin = {}, 1
    for j, c in enumerate(feats):
        k = 2 if j == 6 else 3
        conv[f"Conv_{j}"] = {"kernel": (k, k, cin, c), "bias": (c,)}
        cin = c
    stats = {}
    for j, c in enumerate(feats[4:6]):
        conv[f"BatchNorm_{j}"], stats[f"BatchNorm_{j}"] = _bn(c)
    params = {"ConvStack_0": conv, "Dense_0": {"kernel": (2 * H, V),
                                               "bias": (V,)}}
    for cell in range(4):
        cin = feats[6] if cell < 2 else 2 * H
        params[f"OptimizedLSTMCell_{cell}"] = {
            **{"i" + g: {"kernel": (cin, H)} for g in "ifgo"},
            **{"h" + g: {"kernel": (H, H), "bias": (H,)} for g in "ifgo"}}
    v = {"params": _random_tree(rng, params),
         "batch_stats": {"ConvStack_0": _random_tree(rng, stats)}}
    return t_convert.state_dict_from_crnn(v), j_export.state_dict_from_crnn(v)


def _state_dicts():
    for got, want in (_state_dict_unet(), _state_dict_crnn()):
        assert list(got) == list(want) and len(got) > 20
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _words():
    from qea_ocr_tpu.data.datasets import SyntheticWordDataset as JWords
    from qea_ocr_tpu_torch.data.datasets import SyntheticWordDataset as TWords
    jw, tw = JWords(11, seed=4), TWords(11, seed=4)
    assert tw.names == jw.names
    jc, tc = JCharMap.default(), TCharMap.default()
    jb = j_pipeline.collate_words(jw.samples[:7], jc)
    tb = t_pipeline.collate_words(tw.samples[:7], tc)
    _assert_batches_equal(tb, jb)
    _assert_batches_equal(t_pipeline.pad_wordbatch(tb, 10),
                          j_pipeline.pad_wordbatch(jb, 10))
    _assert_batches_equal(t_pipeline.blank_wordbatch(tb, 3),
                          j_pipeline.blank_wordbatch(jb, 3))
    for opts in (dict(seed=2, epoch=1), dict(shuffle=False, drop_last=False)):
        jbs = list(j_pipeline.batch_iterator(
            jw, 4, lambda s: j_pipeline.collate_words(s, jc), **opts))
        tbs = list(t_pipeline.batch_iterator(
            tw, 4, lambda s: t_pipeline.collate_words(s, tc), **opts))
        assert len(tbs) == len(jbs) > 1
        for tb, jb in zip(tbs, jbs):
            _assert_batches_equal(tb, jb)


def _native():
    from qea_ocr_tpu.utils import native as j_native
    from qea_ocr_tpu_torch.utils import native as t_native
    assert t_native._LIB_PATH == j_native._LIB_PATH
    assert t_native.have_native() == j_native.have_native()
    rng = np.random.default_rng(9)
    B, L1, L2 = 40, 31, 100
    a, b = rng.integers(1, 6, (B, L1)), rng.integers(1, 6, (B, L2))
    a_len, b_len = rng.integers(0, L1 + 1, B), rng.integers(0, 40, B)
    b[:8, :L1] = a[:8]
    b_len[:8] = a_len[:8]
    for fn, args in (("batch_levenshtein", (a, a_len, b, b_len)),
                     ("compare_labels", (a, a_len, b, b_len)),
                     ("pairwise_levenshtein", (b[:, :8].reshape(8, 5, 8),
                                               b_len.reshape(8, 5) % 9)),
                     ("ctc_collapse", (a, 0, 95)),
                     ("facility_location_indices", (rng.random(30), 7))):
        got, want = getattr(t_native, fn)(*args), getattr(j_native, fn)(*args)
        for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, want))):
            np.testing.assert_array_equal(g, w, err_msg=fn)
    assert t_native.compare_labels(a, a_len, b, b_len)[0] >= 8
    words = ["".join(rng.choice(list("abcé "), rng.integers(0, 12)))
             for _ in range(30)]
    assert t_native.string_cer(words, words[::-1]) \
        == j_native.string_cer(words, words[::-1])


def _cer_of_batch():
    from qea_ocr_tpu.tools.cer_seed import cer_of_batch as j_cer
    from qea_ocr_tpu_torch.tools.cer_seed import cer_of_batch as t_cer
    rng = np.random.default_rng(10)
    chars = list(j_config.CHAR_SET[1:20]) + ["é", " "]
    gts = ["".join(rng.choice(chars, rng.integers(0, 15))) for _ in range(25)]
    ocr = [g[: len(g) // 2] + "x" if i % 3 else g for i, g in enumerate(gts)]
    got = t_cer(ocr, gts, TCharMap.default())
    want = j_cer(ocr, gts, JCharMap.default())
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got == 0).sum() >= 5 and (got > 0).sum() >= 5


def _reference_pickle():
    """The unpickler of `tools/import_torch.py`: one whole-module pickle of
    a class whose module is gone (with a DataParallel `module.` segment, a
    batch norm's counter and a float64 tensor) and one state_dict pickle,
    through both loaders."""
    import sys
    import tempfile
    import types
    from pathlib import Path

    import torch

    from qea_ocr_tpu.tools.import_torch import load_torch_state_dict as j_load
    from qea_ocr_tpu_torch.tools.import_torch import (
        load_torch_state_dict as t_load)
    mod = types.ModuleType("qea_gone_reference")
    cls = type("Convolutional", (torch.nn.Module,),
               {"__module__": mod.__name__})
    mod.Convolutional = cls
    sys.modules[mod.__name__] = mod
    torch.manual_seed(0)
    net, inner = cls(), cls()
    inner.add_module("conv1", torch.nn.Conv2d(1, 3, 3))
    inner.add_module("batchnorm1", torch.nn.BatchNorm2d(3))
    net.add_module("convo", torch.nn.DataParallel(inner))
    net.register_buffer("scale", torch.arange(4, dtype=torch.float64))
    with tempfile.TemporaryDirectory() as tmp:
        whole, sd = Path(tmp) / "whole", Path(tmp) / "sd"
        torch.save(net, whole)
        torch.save(net.state_dict(), sd)
        del sys.modules[mod.__name__]
        for path in (whole, sd):
            got, want = t_load(str(path)), j_load(str(path))
            assert list(got) == list(want) and "convo.conv1.weight" in got
            assert not any(k.endswith("num_batches_tracked") for k in got)
            for k in want:
                assert got[k].dtype == want[k].dtype == np.float32, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", [_config, _charmap, _documents, _fake_ocr,
                                  _ocr_factory,
                                  _state_dicts, _batch_iterator, _ocr_engine,
                                  _words, _native, _cer_of_batch,
                                  _reference_pickle, _multihost],
                         ids=lambda f: f.__name__[1:])
def test_copy_equals_original(case):
    case()
