"""The port's evaluators (`qea_ocr_tpu_torch/eval/`, `cli/eval_prep.py`,
`cli/eval_crnn.py`) against the JAX package's, on the CPU.

Each side loads the same weights from its own checkpoint format: a flax
tree written by the JAX package's `save_checkpoint` (orbax), and the same
tree through the port's `tools/convert.py` as a state_dict file. The
models run float32 on both sides (UNet f=8, CRNN hidden 32): each
evaluator's model class is replaced by its float32 form, and the JAX
side's flax `init` is answered by the test's variables (a flax init takes
tens of seconds on the CPU). Worlds: 5 synthetic documents of 96x128 (or
160x128 for the CRNN's 8 strips a document) in batches of 2, so the tail
batch is padded, and 8 word crops in batches of 4.

The UNet is not random: its identity path through level 1 (the centre taps
of enc1 and dec1 on channel 0) carries the document, and a 1x1 output conv
of gain 8 and bias -4 maps it to sigmoid(8x - 4), with every other weight
drawn at a twentieth of its scale. A random UNet outputs a flat grey that
the fake OCR, which binarises at an Otsu threshold, reads as nothing.

Comparisons, strips first: every batch of images the evaluator sends to the
OCR, the cleaned ones to 1e-5 absolute (float32 convs summed in another
order) and the original strips exactly; then the OCR's texts and the
printed results must be equal, and the returned accuracy and CER to 1e-6
relative. The CRNN evaluator's decodes are compared through its printed
counts and CER.
"""

import dataclasses
import os
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flax_variables_like, parser_flags
from qea_ocr_tpu.cli import eval_crnn as j_cli_crnn
from qea_ocr_tpu.cli import eval_prep as j_cli_prep
from qea_ocr_tpu.eval import eval_crnn as j_eval_crnn
from qea_ocr_tpu.eval import eval_prep as j_eval_prep
from qea_ocr_tpu.models import CRNN as JCRNN
from qea_ocr_tpu.models import UNet as JUNet
from qea_ocr_tpu.ops.edit_distance import \
    compare_labels_device as j_compare
from qea_ocr_tpu.tools.import_torch import convert_unet
from qea_ocr_tpu.train.state import ModelState, adam_l2
from qea_ocr_tpu.utils.io import save_checkpoint
from qea_ocr_tpu_torch.cli import eval_crnn as t_cli_crnn
from qea_ocr_tpu_torch.cli import eval_prep as t_cli_prep
from qea_ocr_tpu_torch.eval import eval_crnn as t_eval_crnn
from qea_ocr_tpu_torch.eval import eval_prep as t_eval_prep
from qea_ocr_tpu_torch.eval.eval_utils import prep_eval
from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.ops.edit_distance import compare_labels_device
from qea_ocr_tpu_torch.tools.convert import crnn_state_dict, unet_state_dict

F, HIDDEN = 8, 32
CORRUPTION = dict(noise_std=0.1, shading=0.15, salt_pepper=0.0)
STRIP_ATOL = 1e-5


def _unet_variables(seed):
    """flax variables of the near-identity UNet described above."""
    g = torch.Generator().manual_seed(seed)
    sd = {k: v.clone() for k, v in UNet(init_features=F,
                                        generator=g).state_dict().items()}
    for k, v in sd.items():
        if k.endswith("running_var"):
            v.fill_(1.0)
        elif k.endswith("running_mean"):
            v.zero_()
        elif "norm" in k and k.endswith("weight"):
            v.mul_(0.05).add_(1.0)
        elif not k.endswith("num_batches_tracked"):
            v.mul_(0.05)
    for name, cin in (("encoder1.enc1conv1", 0), ("encoder1.enc1conv2", 0),
                      ("decoder1.dec1conv1", F), ("decoder1.dec1conv2", 0)):
        sd[name + ".weight"][0, cin, 1, 1] = 1.0
    sd["conv.weight"][0, 0] = 8.0
    sd["conv.bias"][0] = -4.0
    return convert_unet({k: v.numpy() for k, v in sd.items()})


def _recording(evaluator, store):
    """Record every batch of images `evaluator` sends to its OCR, and the
    texts that come back."""
    query = evaluator.ocr.query

    def recorded(images, *a, **k):
        res = query(images, *a, **k)
        store.append((np.array(images), list(res.texts)))
        return res
    evaluator.ocr.query = recorded
    return evaluator


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_weights")
    pv = _unet_variables(21)
    cv = flax_variables_like(
        JCRNN(vocab_size=95, lstm_hidden=HIDDEN, compute_dtype=jnp.float32),
        CRNN(95, lstm_hidden=HIDDEN,
             generator=torch.Generator().manual_seed(22)),
        (1, 1, 32, 128), 22)
    paths = {}
    for name, v, to_sd in (("prep", pv, unet_state_dict),
                           ("crnn", cv, crnn_state_dict)):
        paths["jax_" + name] = str(tmp / f"jax_{name}")
        save_checkpoint(paths["jax_" + name],
                        ModelState.create(v, adam_l2(1e-4)))
        paths["port_" + name] = str(tmp / f"port_{name}")
        torch.save(to_sd(v), paths["port_" + name])
    return dict(pv=pv, cv=cv, **paths)


def _run_pair(weights, kind, capsys, **cfg):
    """Build and run the JAX and the port evaluator of `kind` on one
    world; returns {side: (result, OCR record, printed lines)}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        if kind == "prep":
            mp.setattr(j_eval_prep, "UNet",
                       partial(JUNet, compute_dtype=jnp.float32))
            mp.setattr(JUNet, "init", lambda self, *a, **k: weights["pv"])
            mp.setattr(t_eval_prep, "UNet",
                       partial(UNet, compute_dtype=torch.float32))
            sides = (("jax", j_eval_prep.EvalPrep, j_eval_prep.EvalPrepConfig,
                      dict(prep_path=weights["jax_prep"])),
                     ("port", t_eval_prep.EvalPrep,
                      t_eval_prep.EvalPrepConfig,
                      dict(prep_path=weights["port_prep"], device="cpu")))
            cfg = dict(cfg, unet_features=F)
        else:
            mp.setattr(j_eval_crnn, "CRNN",
                       partial(JCRNN, compute_dtype=jnp.float32))
            mp.setattr(JCRNN, "init", lambda self, *a, **k: weights["cv"])
            mp.setattr(t_eval_crnn, "CRNN",
                       partial(CRNN, compute_dtype=torch.float32))
            sides = (("jax", j_eval_crnn.EvalCRNN, j_eval_crnn.EvalCrnnConfig,
                      dict(crnn_path=os.path.dirname(weights["jax_crnn"]),
                           crnn_model_name="jax_crnn")),
                     ("port", t_eval_crnn.EvalCRNN,
                      t_eval_crnn.EvalCrnnConfig,
                      dict(crnn_path=os.path.dirname(weights["port_crnn"]),
                           crnn_model_name="port_crnn", device="cpu")))
            cfg = dict(cfg, lstm_hidden=HIDDEN)
        for side, cls, cfg_cls, own in sides:
            record = []
            ev = _recording(cls(cfg_cls(ocr="Fake", corruption=CORRUPTION,
                                        show_orig=True, **cfg, **own)),
                            record)
            capsys.readouterr()
            result = ev.eval()
            out[side] = (result, record, capsys.readouterr().out)
    return out


def _check_pair(out, strips_atol):
    (j_res, j_rec, j_out), (t_res, t_rec, t_out) = out["jax"], out["port"]
    assert len(t_rec) == len(j_rec) > 0
    for (t_img, t_txt), (j_img, j_txt), atol in zip(t_rec, j_rec,
                                                    strips_atol):
        assert t_img.shape == j_img.shape
        np.testing.assert_allclose(t_img, j_img, atol=atol, rtol=0)
        assert t_txt == j_txt
    assert t_out.splitlines() == j_out.splitlines() and t_out
    np.testing.assert_allclose(t_res, j_res, rtol=1e-6)


def test_eval_prep_patch_world_matches_jax(weights, capsys):
    out = _run_pair(weights, "prep", capsys, dataset="synthetic_patch",
                    synthetic_docs=5, batch_docs=2, max_strips=4,
                    synthetic_strips_per_doc=3, doc_size=(96, 128))
    # per batch: the original strips (exact), then the cleaned ones
    _check_pair(out, [0.0, STRIP_ATOL] * 3)
    # the cleaned strips of 5 documents, 3 each, and the OCR reads them
    texts = [t for _, txt in out["port"][1][1::2] for t in txt]
    assert len(texts) == 15 and sum(map(bool, texts)) >= 5
    acc, cer = out["port"][0]
    assert 0.0 < acc and cer < 1.0


def test_eval_prep_area_world_matches_jax(weights, capsys):
    out = _run_pair(weights, "prep", capsys, dataset="synthetic_area",
                    synthetic_size=8, batch_size=4)
    # per batch: the cleaned crops, then the original ones (exact)
    _check_pair(out, [STRIP_ATOL, 0.0] * 2)


def test_eval_crnn_patch_world_matches_jax(weights, capsys):
    out = _run_pair(weights, "crnn", capsys, dataset="synthetic_patch",
                    synthetic_docs=5, batch_docs=2, max_strips=8,
                    doc_size=(160, 128))
    _check_pair(out, [0.0] * 3)
    assert "Correct count from CRNN" in out["port"][2]


def test_eval_crnn_area_world_matches_jax(weights, capsys):
    out = _run_pair(weights, "crnn", capsys, dataset="synthetic_area",
                    synthetic_size=8, batch_size=4)
    _check_pair(out, [0.0] * 2)


def test_prep_eval_api_and_cli_on_the_cpu(weights, capsys):
    kw = dict(prep_path=weights["port_prep"], dataset="synthetic_patch",
              ocr="Fake", synthetic_docs=3, batch_docs=2, max_strips=4,
              synthetic_strips_per_doc=3, doc_size=(96, 128),
              unet_features=F, device="cpu")
    res = prep_eval(kw)
    assert set(res) == {"test_accuracy", "test_cer"}
    (acc, cer), original = t_cli_prep.main([
        "--prep_path", weights["port_prep"], "--dataset", "synthetic_patch",
        "--ocr", "Fake", "--synthetic_docs", "3", "--batch_docs", "2",
        "--max_strips", "4", "--synthetic_strips_per_doc", "3",
        "--doc_size", "96", "128", "--unet_features", str(F),
        "--device", "cpu", "--show_orig"])
    assert (acc, cer) == (res["test_accuracy"], res["test_cer"])
    assert original is not None and 0.0 <= original[0] <= 1.0
    acc, cer = t_cli_crnn.main([
        "--crnn_path", os.path.dirname(weights["port_crnn"]),
        "--crnn_model_name", "port_crnn", "--dataset", "synthetic_area",
        "--ocr", "Fake", "--synthetic_size", "4", "--batch_size", "4",
        "--lstm_hidden", str(HIDDEN), "--device", "cpu"])
    assert 0.0 <= acc <= 1.0 and np.isfinite(cer)


def test_cmajor_route_outside_its_coverage_raises(weights, monkeypatch):
    """`QEA_CONV_IMPL=cmajor` on a width the route does not cover (136 is
    not a multiple of 16) raises; it does not fall back to cuDNN."""
    monkeypatch.setenv("QEA_CONV_IMPL", "cmajor")
    ev = t_eval_prep.EvalPrep(t_eval_prep.EvalPrepConfig(
        prep_path=weights["port_prep"], dataset="synthetic_patch",
        ocr="Fake", synthetic_docs=2, batch_docs=2, max_strips=4,
        synthetic_strips_per_doc=3, doc_size=(96, 136), unet_features=F,
        device="cpu"))
    assert ev.prep_model.conv_impl == "cmajor"
    with pytest.raises(ValueError, match="does not cover"):
        ev.eval()


@pytest.mark.parametrize("seed", [0, 1])
def test_compare_labels_at_widths_31_and_100(seed):
    """Decodes of width T=31 against labels of width L=100, as the
    evaluators and the warmup's eval step call it: equal rows, a prefix, a
    longer label, empty rows, and a mask."""
    rng = np.random.default_rng(seed)
    B, T, L = 12, 31, 100
    gt = np.full((B, L), 95, np.int32)
    gt_len = rng.integers(0, 40, B).astype(np.int32)
    gt_len[:3] = (5, 31, 0)
    for i in range(B):
        gt[i, :gt_len[i]] = rng.integers(1, 95, gt_len[i])
    pred = np.full((B, T), 95, np.int32)
    pred_len = np.minimum(gt_len, T).astype(np.int32)
    for i in range(B):
        pred[i, :pred_len[i]] = gt[i, :pred_len[i]]
    pred[3, 0] = (pred[3, 0] % 94) + 1            # one substitution
    pred_len[4] = max(0, pred_len[4] - 2)         # a prefix
    mask = np.ones(B, bool)
    mask[5] = False
    for m in (None, mask):
        args = (pred, pred_len, gt, gt_len)
        want = [np.asarray(x) for x in j_compare(
            *map(jnp.asarray, args),
            None if m is None else jnp.asarray(m))]
        got = [x.numpy() for x in compare_labels_device(
            *map(torch.from_numpy, args),
            None if m is None else torch.from_numpy(m))]
        assert float(got[0]) == float(want[0]) and float(got[0]) >= 2
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("kind", ["prep", "crnn"])
def test_cli_flags_and_configs_equal_the_jax_ones(kind):
    jcli, tcli = {"prep": (j_cli_prep, t_cli_prep),
                  "crnn": (j_cli_crnn, t_cli_crnn)}[kind]
    j, t = parser_flags(jcli.build_parser()), parser_flags(
        tcli.build_parser())
    assert t.pop("device")["default"] == "cuda"
    assert list(t) == list(j)
    for dest in j:
        assert t[dest] == j[dest], dest
    jcfg, tcfg = {"prep": (j_eval_prep.EvalPrepConfig,
                           t_eval_prep.EvalPrepConfig),
                  "crnn": (j_eval_crnn.EvalCrnnConfig,
                           t_eval_crnn.EvalCrnnConfig)}[kind]
    jf = {f.name: f.default for f in dataclasses.fields(jcfg)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg)}
    assert tf.pop("device") == "cuda"
    assert tf == jf
