"""The port's CRNN warmup (`qea_ocr_tpu_torch/train/crnn_trainer.py`,
`cli/train_crnn.py`) against the JAX package's, on the CPU.

Parity: one train step and one eval step of `TrainCRNN` against the JAX
trainer's `_train_step` / `_eval_step` at the same weights (CRNN hidden 32,
float32 on both sides, Adam 1e-3 without decay) on the same noisy batch of 8
synthetic crops; the noise is drawn by each trainer's `_noise` from the same
seed and must be bitwise equal, and the JAX side's noisy images feed both
steps. The JAX trainer is built by its own `__init__`, with its model's
flax `init` answered by the test's variables (a flax init of the CRNN takes
tens of seconds on the CPU).

Tolerances, as in `tests/test_torch_train_step.py` (whose docstring says why
gradients are compared per tensor and parameters only where the gradient is
not float32 noise): loss rel 1e-5; each gradient tensor to 1e-4 of its own
largest entry, and 1e-2 for batchnorm1 and the convs above it, where an
activation next to a ReLU boundary may fall the other way (`GRAD_RTOL*`
below; JAX's gradients read back from Adam's first moment, mu = 0.1 g);
parameters after the step abs 1e-5 where the gradient exceeds a hundredth
of its tensor's largest; batch statistics abs 1e-6. The biases of conv5 and
conv6 feed a train-mode batch norm, so their exact gradient is zero: both
sides' must lie below 1e-4 of the model's largest gradient, and Adam may move
each of their entries by lr either way. Eval step: loss rel
1e-5, CER sum rel 1e-6, exact count and decodes equal.

Then the port alone trains a tiny world end to end (mirroring the JAX
package's `tests/test_crnn_trainer.py`): the loss falls, the query ledger,
checkpoints that reload and resume, and the ground-truth path without an
OCR.
"""

import dataclasses
import glob
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flax_variables_like, jax_variables, parser_flags
from qea_ocr_tpu.cli import train_crnn as jcli
from qea_ocr_tpu.models import CRNN as JCRNN
from qea_ocr_tpu.train import crnn_trainer as jtrainer
from qea_ocr_tpu_torch.cli import train_crnn as tcli
from qea_ocr_tpu_torch.data.pipeline import collate_words, pad_wordbatch
from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.models.proxy import build_proxy
from qea_ocr_tpu_torch.tools.convert import crnn_state_dict
from qea_ocr_tpu_torch.train import crnn_trainer as ttrainer
from qea_ocr_tpu_torch.utils.io import OPTIM_SUFFIX, load_checkpoint

B, HIDDEN, LR, SEED = 8, 32, 1e-3, 13
# Biases of the convs that feed a train-mode batch norm: it removes any
# per-channel shift, so their exact gradient is zero and each side's is
# float32 noise
ZERO_GRAD = ("convo.conv5.bias", "convo.conv6.bias")
# Gradients: each tensor against its own largest entry. Below the ReLU
# after batchnorm1 they are sums in another order (measured: at most 2e-5).
# On this batch four of batchnorm1's outputs lie within 1e-5 of that ReLU
# (the closest 1.6e-6), so one can fall on the other side in the other
# framework; batchnorm1 and every tensor above it then differ by that
# position's share (measured: 2.2e-3 at batchnorm1.bias, at most 9.4e-4 above)
GRAD_RTOL = 1e-4
GRAD_RTOL_ABOVE_BN1 = 1e-2
ABOVE_BN1 = tuple(f"convo.conv{i}." for i in range(1, 6)) + (
    "convo.batchnorm1.",)
CORRUPTION = dict(noise_std=0.05, shading=0.1, salt_pepper=0.0)


def _cfg(cls, **kw):
    base = dict(batch_size=B, lr=LR, dataset="synthetic",
                synthetic_train_size=B, synthetic_val_size=6,
                corruption=CORRUPTION, lstm_hidden=HIDDEN, std=5,
                random_seed=SEED)
    return cls(**{**base, **kw})


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("crnn_parity")
    port_init = CRNN(95, lstm_hidden=HIDDEN,
                     generator=torch.Generator().manual_seed(SEED))
    jmodel = JCRNN(vocab_size=95, lstm_hidden=HIDDEN,
                   compute_dtype=jnp.float32)
    cv = flax_variables_like(jmodel, port_init, (1, 1, 32, 128), SEED)
    ckpt = str(tmp / "init")
    torch.save(crnn_state_dict(cv), ckpt)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "CRNN",
                   partial(JCRNN, compute_dtype=jnp.float32))
        mp.setattr(JCRNN, "init", lambda self, *a, **k: cv)
        jt = jtrainer.TrainCRNN(_cfg(jtrainer.CrnnTrainerConfig))
        mp.setattr(ttrainer, "build_proxy",
                   partial(build_proxy, compute_dtype=torch.float32))
        # the port loads the same weights from a state_dict file
        pt = ttrainer.TrainCRNN(_cfg(ttrainer.CrnnTrainerConfig,
                                     device="cpu", ckpt_path=ckpt))
    cm = pt.charmap
    assert cm.vocab_size == 95

    batch = collate_words([pt.train_ds[i] for i in range(B)], cm)
    noise = dict(jax=[jt._noise(batch.images) for _ in range(2)],
                 port=[pt._noise(batch.images) for _ in range(2)])
    images = noise["jax"][1]

    # eval step first, on the initial weights: 6 real rows and 2 padding
    val = pad_wordbatch(collate_words([pt.val_ds[i] for i in range(6)], cm),
                        B)
    mask = np.arange(B) < 6
    j_eval = [np.asarray(x) for x in jt._eval_step(
        jt.state, jnp.asarray(val.images), jnp.asarray(val.labels),
        jnp.asarray(val.lengths), jnp.asarray(mask))]
    t_eval = [_np(x) for x in pt._eval_step(
        *map(torch.from_numpy, (val.images, val.labels, val.lengths,
                                mask)))]

    state, j_loss = jt._train_step(
        jt.state, jnp.asarray(images), jnp.asarray(batch.labels),
        jnp.asarray(batch.lengths))
    adam = state.opt_state.inner_state[1]
    j_vars = jax_variables(state)
    mu = {"params": jax.tree_util.tree_map(np.asarray, dict(adam.mu)),
          "batch_stats": j_vars["batch_stats"]}
    t_loss = pt._train_step(*map(torch.from_numpy, (
        images, batch.labels, batch.lengths)))
    return dict(cv=cv, noise=noise, j_eval=j_eval, t_eval=t_eval,
                j_loss=float(j_loss), t_loss=float(t_loss),
                j_after=crnn_state_dict(j_vars),
                j_grads=crnn_state_dict(mu), pt=pt, val_mask=mask)


def test_noise_is_the_jax_trainers_bit_for_bit(world):
    for j, t in zip(world["noise"]["jax"], world["noise"]["port"]):
        assert t.dtype == j.dtype == np.float32
        np.testing.assert_array_equal(t, j)
    assert not np.array_equal(world["noise"]["jax"][0],
                              world["noise"]["jax"][1])


def test_train_step_loss_and_gradients_match_jax(world):
    np.testing.assert_allclose(world["t_loss"], world["j_loss"], rtol=1e-5)
    grads = {k: _np(p.grad) for k, p in
             world["pt"].model.named_parameters()}
    assert len(grads) > 20
    top = max(np.abs(g).max() for g in grads.values())
    for k, g in grads.items():
        want = world["j_grads"][k].numpy() / 0.1
        if k in ZERO_GRAD:
            # float32 noise on both sides
            assert max(np.abs(g).max(), np.abs(want).max()) < 1e-4 * top, k
            continue
        rel = GRAD_RTOL_ABOVE_BN1 if k.startswith(ABOVE_BN1) else GRAD_RTOL
        worst, scale = np.abs(g - want).max(), np.abs(want).max()
        assert worst <= rel * scale, (k, worst, scale)


def test_train_step_parameters_and_statistics_match_jax(world):
    model = world["pt"].model
    got = model.state_dict()
    params = dict(model.named_parameters())
    want = world["j_after"]
    before = crnn_state_dict(world["cv"])
    assert set(got) == set(want)
    checked = total = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, w = _np(got[k]), w.numpy()
        if k in ZERO_GRAD:
            # Adam's first step moves each entry by lr * sign(noise)
            assert np.abs(g - before[k].numpy()).max() <= 1.01 * LR, k
        elif k in params:
            grad = np.abs(_np(params[k].grad))
            sure = grad > 1e-2 * grad.max()
            checked, total = checked + sure.sum(), total + sure.size
            np.testing.assert_allclose(g[sure], w[sure], atol=1e-5, rtol=0,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=k)
    assert checked > 0.2 * total, (checked, total)
    # the train-mode forward moved the batch statistics; bias_ih is a
    # buffer no optimizer moves
    for k in ("convo.batchnorm1.running_mean", "convo.batchnorm2.running_var"):
        assert not torch.equal(got[k], before[k]), k
    assert torch.equal(got["lstm.bias_ih_l0"], before["lstm.bias_ih_l0"])


def test_eval_step_matches_jax(world):
    (jl, jc, js, jd, jn), (tl, tc, ts, td, tn) = world["j_eval"], \
        world["t_eval"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert float(tc) == float(jc)
    np.testing.assert_allclose(ts, js, rtol=1e-6)
    assert float(js) > 0
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tn, jn)
    assert td.shape == (B, 31)


def test_cli_flags_and_config_equal_the_jax_ones():
    j, t = parser_flags(jcli.build_parser()), parser_flags(
        tcli.build_parser())
    assert t.pop("device")["default"] == "cuda"
    assert t.pop("proxy")["default"] == "crnn"
    assert list(t) == list(j)
    for dest in j:
        assert t[dest] == j[dest], dest
    jf = {f.name: f.default
          for f in dataclasses.fields(jtrainer.CrnnTrainerConfig)}
    tf = {f.name: f.default
          for f in dataclasses.fields(ttrainer.CrnnTrainerConfig)}
    assert tf.pop("device") == "cuda"
    assert tf.pop("proxy") == "crnn"
    assert tf == jf
    cfg = tcli.config_from_args(tcli.build_parser().parse_args(
        ["--device", "cpu", "--dataset", "synthetic", "--random_std",
         "--epoch", "3", "--lstm_hidden", "16"]))
    assert (cfg.device, cfg.random_std, cfg.epochs, cfg.lstm_hidden) \
        == ("cpu", False, 3, 16)


def test_unported_and_missing_gpu_raise(tmp_path, monkeypatch):
    # data_parallel without a process group is a world of one
    trainer = ttrainer.TrainCRNN(_cfg(ttrainer.CrnnTrainerConfig,
                                      data_parallel=True, device="cpu"))
    assert (trainer._pc, trainer._bl, trainer.group) == (1, B, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrainer.TrainCRNN(_cfg(ttrainer.CrnnTrainerConfig))


# ------------------------------------------------- the port's trainer alone
TRAIN, VAL, EPOCHS = 64, 16, 3


def _tiny(tmp, **kw):
    base = dict(batch_size=16, lr=3e-4, epochs=EPOCHS, dataset="synthetic",
                synthetic_train_size=TRAIN, synthetic_val_size=VAL,
                corruption=dict(noise_std=0.03, shading=0.05,
                                salt_pepper=0.0),
                ocr="Fake", lstm_hidden=64, std=2, device="cpu",
                crnn_model_path=str(tmp / "model"), log_dir=str(tmp))
    return ttrainer.CrnnTrainerConfig(**{**base, **kw})


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("crnn")
    trainer = ttrainer.TrainCRNN(_tiny(tmp))
    best_acc, best_epoch = trainer.train()
    return trainer, best_acc, best_epoch, tmp


def _ckpts(tmp):
    return sorted(p for p in glob.glob(str(tmp / "model_*"))
                  if not p.endswith(OPTIM_SUFFIX))


def test_loss_falls_and_the_ledger_is_exact(trained):
    trainer, best_acc, best_epoch, tmp = trained
    recs = _records(trainer.logger.log_path)
    assert [r["Epoch"] for r in recs] == [1, 2, 3]
    assert recs[-1]["train_loss"] < recs[0]["train_loss"]
    assert all(np.isfinite(r["val_loss"]) for r in recs)
    # every training crop and every validation crop is one query an epoch
    assert trainer.ocr.total_calls == EPOCHS * (TRAIN + VAL)
    assert trainer.ocr.count_calls == trainer.ocr.total_calls
    assert [r["Total Black-Box Calls"] for r in recs] == \
        [(i + 1) * (TRAIN + VAL) for i in range(EPOCHS)]
    assert 0.0 <= best_acc <= 1.0
    # StepLR(10, 0.8): the first ten epochs at the base rate
    assert {r["lr"] for r in recs} == {3e-4}


def test_checkpoint_reloads_and_resumes(trained):
    trainer, _, _, tmp = trained
    ckpts = _ckpts(tmp)
    last = [p for p in ckpts if "model_2_" in p]
    assert len(last) == 1 and all(
        glob.glob(p + OPTIM_SUFFIX) for p in ckpts)
    # the last epoch's checkpoint is the trainer's final state
    model = CRNN(95, lstm_hidden=64)
    load_checkpoint(last[0], model)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    # resume for one more epoch from it: one epoch's queries, epoch 4 logged
    log = tmp / "resume"
    resumed = ttrainer.TrainCRNN(_tiny(
        tmp, epochs=EPOCHS + 1, ckpt_path=last[0], start_epoch=EPOCHS - 1,
        log_dir=str(log), crnn_model_path=str(log / "model")))
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    resumed.train()
    recs = _records(resumed.logger.log_path)
    assert [r["Epoch"] for r in recs] == [EPOCHS + 1]
    assert resumed.ocr.total_calls == TRAIN + VAL
    assert glob.glob(str(log / f"model_{EPOCHS}_*"))


def test_gt_label_path_without_an_ocr(tmp_path):
    trainer = ttrainer.TrainCRNN(_tiny(
        tmp_path, batch_size=8, epochs=1, synthetic_train_size=16,
        synthetic_val_size=8, ocr=None, lstm_hidden=32,
        corruption=dict(noise_std=0.0, shading=0.0, salt_pepper=0.0)))
    best_acc, _ = trainer.train()
    assert trainer.ocr is None
    assert 0.0 <= best_acc <= 1.0
    assert _ckpts(tmp_path)
