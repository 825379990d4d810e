"""The port's ways across its boundary, on the CPU.

Import (`qea_ocr_tpu_torch/tools/import_torch.py`): reference-named
whole-module pickles whose defining module cannot be imported, made as the
JAX package's `tests/test_import_torch.py` makes them (from
`benchmarks/torch_baseline.build_models`, with non-trivial batch norms), and
plain state_dicts with `nn.DataParallel`'s `convo.module.` prefix. The port's
models on the imported weights give the reference twin's forward in float32
(UNet abs 1e-5, CRNN log-probs abs 1e-4), and the imported state_dict is the
one the JAX package's importer followed by `tools/convert.py` reaches
(exactly). A checkpoint of another capacity fails, naming the mismatch. The
output loads where `--prep_model`, `--crnn_model` and `--prep_path` load it.

Export (`qea_ocr_tpu_torch/tools/export_model.py`): a UNet(4) checkpoint
exported at (2, 1, 64, 64) is loaded by a Python process that cannot import
the port, and its output equals the eager eval forward on the same input (on
the CPU both run the same bfloat16 operations: abs 1e-6, where the JAX export
test allows 2e-2). With `QEA_CONV_IMPL=cmajor` the artifact holds the conv
operator, one `qea_ocr::conv_flat` node a conv (8), and reproduces the
eager channel-major forward bitwise.
"""

import json
import subprocess
import sys
from collections import OrderedDict

import numpy as np
import pytest
import torch

from benchmarks.torch_baseline import build_models
from qea_ocr_tpu.tools.import_torch import convert_crnn, convert_unet
from qea_ocr_tpu.tools.import_torch import (
    load_torch_state_dict as jax_load_torch_state_dict)
from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.tools import export_model, import_torch
from qea_ocr_tpu_torch.tools.convert import crnn_state_dict, unet_state_dict
from qea_ocr_tpu_torch.utils.io import load_checkpoint, save_checkpoint
from test_import_torch import (
    _FAKE_MOD, _randomize_bn, _ref_named_crnn, _ref_named_unet,
    _save_unimportable)

import _torch_parity  # noqa: F401  (one torch thread)

V = 23          # the CRNN twin's vocabulary (the charset's is 95)


def _assert_state_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    """A reference UNet(8) and CRNN(V) as whole-module pickles of an
    unimportable module, their twins (eval mode) and a CRNN state_dict with
    the DataParallel prefix."""
    tmp = tmp_path_factory.mktemp("ref")
    rng = np.random.default_rng(0)
    unet, _ = build_models()
    unet = type(unet)(f=8)
    _, crnn = build_models(vocab_size=V)
    for m in (unet, crnn):
        _randomize_bn(m, rng)
        m.eval()
    paths = dict(prep=str(tmp / "Prep_model_7_81.54"),
                 crnn=str(tmp / "CRNN_model_7"), sd=str(tmp / "crnn_sd.pt"))
    _save_unimportable(_ref_named_unet(unet), paths["prep"])
    ref = _ref_named_crnn(crnn)
    sd = OrderedDict(
        ("convo.module." + k[len("convo."):] if k.startswith("convo.")
         else k, v) for k, v in ref.state_dict().items())
    torch.save(ref, paths["crnn"])
    del sys.modules[_FAKE_MOD]
    torch.save(sd, paths["sd"])
    return dict(paths=paths, unet=unet, crnn=crnn, tmp=tmp)


def test_unet_pickle_imports_with_the_reference_forward(pickles):
    out = str(pickles["tmp"] / "prep.pt")
    sd = import_torch.import_prep(pickles["paths"]["prep"], out,
                                  unet_features=8)
    # the JAX importer and the port's converter reach the same state_dict
    _assert_state_dicts_equal(sd, unet_state_dict(convert_unet(
        jax_load_torch_state_dict(pickles["paths"]["prep"]))))
    model = UNet(init_features=8, compute_dtype=torch.float32)
    load_checkpoint(out, model)            # what --prep_model / --prep_path do
    model.eval()
    x = torch.from_numpy(np.random.default_rng(1).random(
        (2, 1, 64, 64), np.float32))
    with torch.no_grad():
        got, want = model(x), pickles["unet"](x)
    assert float((got - want).abs().max()) < 1e-5


@pytest.mark.parametrize("source", ["crnn", "sd"],
                         ids=["whole_module", "dataparallel_state_dict"])
def test_crnn_imports_with_the_reference_forward(pickles, source):
    out = str(pickles["tmp"] / f"crnn_{source}.pt")
    sd = import_torch.import_crnn(pickles["paths"][source], out)
    # the two LSTM biases fold into bias_hh, as the JAX importer's one
    # flax bias becomes bias_hh through tools/convert.py
    assert not sd["lstm.bias_ih_l1_reverse"].any()
    _assert_state_dicts_equal(sd, crnn_state_dict(convert_crnn(
        jax_load_torch_state_dict(pickles["paths"][source]))))
    model = CRNN(V, compute_dtype=torch.float32)
    load_checkpoint(out, model)
    model.eval()
    x = torch.from_numpy(np.random.default_rng(2).random(
        (2, 1, 32, 128), np.float32))
    with torch.no_grad():
        got, want = model(x), pickles["crnn"](x)
    assert got.shape == want.shape == (31, 2, V)
    assert float((got - want).abs().max()) < 1e-4


def test_wrong_capacity_fails_naming_the_mismatch(pickles, tmp_path):
    with pytest.raises(ValueError, match="enc1conv1.weight: checkpoint"):
        import_torch.import_prep(pickles["paths"]["prep"],
                                 str(tmp_path / "p"), unet_features=16)
    with pytest.raises(ValueError, match="lstm.weight_hh_l0: checkpoint"):
        import_torch.import_crnn(pickles["paths"]["crnn"],
                                 str(tmp_path / "c"), lstm_hidden=128)
    assert not list(tmp_path.iterdir())


def test_imported_checkpoints_load_where_users_pass_them(pickles, tmp_path,
                                                         capsys):
    """Through the tool's CLI; then `--prep_model` / `--crnn_model` of the
    area trainer (a CRNN of the charset's 95 classes; `eval_prep` loads its
    `--prep_path` the same way) and `--prep_path` of `clean_docs`'
    cleaner."""
    from qea_ocr_tpu_torch.serve.cleaner import DocumentCleaner
    from qea_ocr_tpu_torch.train.area_trainer import (
        AreaTrainerConfig, TrainNNPrepArea)

    _, crnn95 = build_models()
    crnn95.eval()
    path95 = str(tmp_path / "CRNN_model_95")
    _save_unimportable(_ref_named_crnn(crnn95), path95)
    prep, crnn = str(tmp_path / "prep.pt"), str(tmp_path / "crnn.pt")
    import_torch.main(["--kind", "prep", "--torch_path",
                       pickles["paths"]["prep"], "--out", prep,
                       "--unet_features", "8"])
    import_torch.main(["--kind", "crnn", "--torch_path", path95, "--out",
                       crnn])
    assert capsys.readouterr().out.count("[import_torch] wrote") == 2
    trainer = TrainNNPrepArea(AreaTrainerConfig(
        device="cpu", ocr="Fake", dataset="synthetic", batch_size=4,
        synthetic_train_size=4, synthetic_val_size=4, unet_features=8,
        prep_model=prep, crnn_model=crnn, exp_base_path=str(tmp_path / "x")))
    for model, path in ((trainer.prep_model, prep),
                        (trainer.crnn_model, crnn)):
        _assert_state_dicts_equal(
            {k: v for k, v in model.state_dict().items()},
            torch.load(path, weights_only=True))
    cleaner = DocumentCleaner(prep, unet_features=8, device="cpu",
                              doc_size=(64, 64), batch_size=1)
    out = cleaner.clean_arrays([np.ones((40, 50), np.float32)])
    assert out[0].shape == (40, 50)


# ---------------------------------------------------------------- export
DOC = (64, 64)


@pytest.fixture(scope="module")
def prep_ckpt(tmp_path_factory):
    model = UNet(init_features=4, generator=torch.Generator().manual_seed(3))
    _randomize_bn(model, np.random.default_rng(3))
    path = str(tmp_path_factory.mktemp("export") / "Prep_model_0_0.00")
    save_checkpoint(path, model)
    return path


def test_export_reloads_without_the_package(prep_ckpt, tmp_path, capsys):
    out = tmp_path / "prep.pt2"
    export_model.main(["--prep_path", prep_ckpt, "--out", str(out),
                       "--batch_size", "2", "--doc_size", *map(str, DOC),
                       "--unet_features", "4", "--device", "cpu"])
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info == {"out": str(out), "bytes": out.stat().st_size,
                    "input_shape": [2, 1, *DOC], "device": "cpu",
                    "conv_impl": "xla", "cmajor_fused": None,
                    "conv_flat_nodes": 0}
    x = np.random.default_rng(4).random((2, 1, *DOC), np.float32)
    np.save(tmp_path / "x.npy", x)
    # -I: no PYTHONPATH, no current directory; run from outside the repo
    code = ("import sys, numpy as np, torch\n"
            "try:\n    import qea_ocr_tpu_torch\nexcept ImportError:\n"
            "    pass\nelse:\n    sys.exit('the package is importable')\n"
            "m = torch.export.load('prep.pt2').module()\n"
            "with torch.no_grad():\n"
            "    y = m(torch.from_numpy(np.load('x.npy')))\n"
            "np.save('y.npy', y.numpy())\n")
    proc = subprocess.run([sys.executable, "-I", "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    model = UNet(init_features=4)
    load_checkpoint(prep_ckpt, model)
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(x)).numpy()
    got = np.load(tmp_path / "y.npy")
    assert got.shape == want.shape == (2, 1, *DOC)
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("fused", ["1", "0"])
def test_cmajor_export_writes_the_conv_operator(prep_ckpt, tmp_path,
                                                monkeypatch, capsys, fused):
    """`QEA_CONV_IMPL=cmajor`: the artifact holds 8 `conv_flat` nodes, fused
    or not, and gives the eager channel-major forward bitwise."""
    monkeypatch.setenv("QEA_CONV_IMPL", "cmajor")
    monkeypatch.setenv("QEA_CMAJOR_FUSED", fused)
    out = tmp_path / "m.pt2"
    export_model.main(["--prep_path", prep_ckpt, "--out", str(out),
                       "--batch_size", "2", "--doc_size", "16", "256",
                       "--unet_features", "4", "--device", "cpu"])
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["conv_impl"] == "cmajor" and info["conv_flat_nodes"] == 8
    assert info["cmajor_fused"] is (fused == "1")
    assert info["bytes"] == out.stat().st_size
    loaded = torch.export.load(str(out))
    assert export_model.conv_flat_nodes(loaded) == 8
    model = UNet(init_features=4, conv_impl="cmajor")
    load_checkpoint(prep_ckpt, model)
    x = torch.from_numpy(
        np.random.default_rng(5).random((2, 1, 16, 256), np.float32))
    with torch.no_grad():
        assert torch.equal(loaded.module()(x), model.eval()(x))
