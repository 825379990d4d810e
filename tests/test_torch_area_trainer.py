"""The port's area (word-crop) trainer
(`qea_ocr_tpu_torch/train/area_trainer.py`) on a tiny synthetic world with
the fake OCR, on the CPU: the cases of the JAX package's
`tests/test_area_eval.py` (the query ledger against the budget formula, the
metrics under the JAX keys, the side files, the cosine learning rates, the
padded validation tail with a train-only ledger, the EMA checkpoint, a round
trip through `eval_prep` on `synthetic_area`), and the options that are not
ported yet.

One test, marked `slow`, runs an epoch of the JAX trainer beside the port's
from the same weights (it compiles the JAX package's steps).
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.train.area_trainer import (
    AreaTrainerConfig, TrainNNPrepArea)
from qea_ocr_tpu_torch.utils.io import OPTIM_SUFFIX, load_checkpoint

import _torch_parity  # noqa: F401  (one torch thread)

CORRUPTION = dict(noise_std=0.08, shading=0.1, salt_pepper=0.0)
TRAIN, VAL, B = 16, 10, 8
# the JAX trainer's record (`qea_ocr_tpu/train/area_trainer.py:561-576`)
JAX_KEYS = ["CRNN_accuracy", "Fake_accuracy", "CRNN_CER", "Fake_cer",
            "Epoch", "train_loss", "val_loss", "Total Black-Box Calls",
            "Black-Box Calls", "Total CRNN Updates", "CRNN Updates",
            "CRNN_loss", "CRNN_OCR_Matching_ACC", "CRNN_OCR_Matching_CER"]


def tiny_cfg(tmp, **overrides):
    base = dict(
        device="cpu", batch_size=B, epochs=2, ocr="Fake",
        dataset="synthetic", synthetic_train_size=TRAIN,
        synthetic_val_size=VAL, corruption=CORRUPTION,
        minibatch_subset="topKCER", minibatch_subset_prop=0.5,
        inner_limit=2, inner_limit_skip=True, window_size=2,
        lstm_hidden=32, unet_features=8, exp_base_path=str(tmp))
    base.update(overrides)
    return AreaTrainerConfig(**base)


def _records(tmp):
    with open(os.path.join(str(tmp), "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _ckpt(tmp, pattern):
    return sorted(p for p in glob.glob(os.path.join(str(tmp), "ckpts",
                                                    pattern))
                  if not p.endswith(OPTIM_SUFFIX))


@pytest.fixture(scope="module")
def area_run(tmp_path_factory):
    """2 epochs, cosine rates on both models, a pretraining epoch and the
    EMA; 10 validation crops in batches of 8, so the tail batch is padded."""
    tmp = tmp_path_factory.mktemp("area")
    trainer = TrainNNPrepArea(tiny_cfg(
        tmp, lr_scheduler="cosine", lr_scheduler_prep="cosine",
        prep_ema=0.9, prep_pretrain_epochs=1))
    best = trainer.train()
    return trainer, best, tmp


# per batch of 8: ceil(8 * 0.5) = 4 crops queried, once clean and once
# jittered: 2 batches x 8 = 16 an epoch; validation reads all 10 crops
TRAIN_CALLS = 2 * 2 * 4


def test_budget_accounting(area_run):
    trainer, _, _ = area_run
    assert trainer.ocr.total_calls == 2 * (TRAIN_CALLS + VAL)
    assert trainer.ocr.count_calls == trainer.ocr.total_calls


def test_metrics_and_sides(area_run):
    _, (best_acc, _), tmp = area_run
    recs = _records(tmp)
    assert [list(r) for r in recs] == [JAX_KEYS] * 2
    assert [r["Epoch"] for r in recs] == [1, 2]
    assert [r["CRNN Updates"] for r in recs] == [2, 2]
    assert all(np.isfinite(r[k]) for r in recs
               for k in ("train_loss", "val_loss", "CRNN_loss"))
    for name in ("tracked_labels/tracked_labels_current.json",
                 "tracked_labels/tracked_labels_1.json",
                 "selected_samples/selected_samples_current.json",
                 "cers/all_cers.json", "img_out/out_1.png",
                 "ckpts/CRNN_model_1", "ckpts/CRNN_model_1" + OPTIM_SUFFIX):
        assert os.path.exists(os.path.join(str(tmp), name)), name
    assert len(_ckpt(tmp, "Prep_model_*_*")) == 2
    # Prep_model_best is written when an epoch's OCR accuracy beats 0
    assert bool(_ckpt(tmp, "Prep_model_best")) == (best_acc > 0)
    with open(os.path.join(str(tmp), "cers", "all_cers.json")) as f:
        cers = json.load(f)
    assert len(cers) == TRAIN and all(len(v) == 2 for v in cers.values())


def test_cosine_lr_applied(area_run):
    trainer, _, _ = area_run
    # epoch index 1 of 2: (1 + cos(pi / 2)) / 2 = 0.5 of the base rate, on
    # both models (lr_scheduler_prep), read from the optimizers themselves
    for opt, base in ((trainer.crnn_optimizer, trainer.cfg.lr_crnn),
                      (trainer.prep_optimizer, trainer.cfg.lr_prep)):
        assert [g["lr"] for g in opt.param_groups] == \
            [pytest.approx(0.5 * base, rel=1e-12)]


def test_val_tail_scored_and_train_only_ledger(area_run, tmp_path):
    """Every validation crop is scored when val_size % batch_size != 0 (the
    tail batch is padded and masked, not dropped), and the logged Black-Box
    counters stay train-only like the reference's area ledger
    (`train_nn_area.py:257-267,306-307`)."""
    _, _, tmp = area_run
    recs = _records(tmp)
    assert [r["Black-Box Calls"] for r in recs] == [TRAIN_CALLS] * 2
    assert [r["Total Black-Box Calls"] for r in recs] == \
        [TRAIN_CALLS, 2 * TRAIN_CALLS]
    # val_size < batch_size: a single padded batch still scores them all;
    # no selection: every training crop is queried once
    small = TrainNNPrepArea(tiny_cfg(
        tmp_path, epochs=1, synthetic_train_size=8, synthetic_val_size=3,
        minibatch_subset=None, inner_limit=1, window_size=1))
    small.train()
    assert small.ocr.total_calls == 8 + 3
    rec = _records(tmp_path)[0]
    assert rec["Black-Box Calls"] == 8 and np.isfinite(rec["val_loss"])


def test_prep_ema_checkpoints_ema_params(area_run):
    """With prep_ema on, validation and checkpoints use the EMA parameters:
    they lag the raw training parameters, and the epoch's checkpoint holds
    the EMA values, not the raw ones."""
    trainer, _, tmp = area_run
    raw = [p.detach() for p in trainer.prep_model.parameters()]
    assert max(float((a - e).abs().max())
               for a, e in zip(raw, trainer.ema_params)) > 0.0
    loaded = UNet(init_features=8)
    load_checkpoint(_ckpt(tmp, "Prep_model_1_*")[0], loaded)
    for got, ema in zip(loaded.parameters(), trainer.ema_params):
        assert torch.equal(got, ema)
    # the batch statistics are the trainer's own (no EMA of those)
    for (k, got), want in zip(loaded.named_buffers(),
                              trainer.prep_model.buffers()):
        assert torch.equal(got, want), k


def test_eval_area_roundtrip(area_run):
    from qea_ocr_tpu_torch.eval.eval_utils import prep_eval

    _, _, tmp = area_run
    out = prep_eval(dict(
        prep_path=_ckpt(tmp, "Prep_model_1_*")[0], dataset="synthetic_area",
        ocr="Fake", batch_size=8, synthetic_size=8, unet_features=8,
        corruption=CORRUPTION, device="cpu"))
    assert set(out) == {"test_accuracy", "test_cer"}
    assert 0.0 <= out["test_accuracy"] <= 1.0
    assert out["test_cer"] >= 0.0


@pytest.mark.parametrize("flag,value,item", [
    ("data_parallel", True, "item 7"), ("optuna_trial", object(), "item 8")])
def test_unported_options_raise_naming_the_roadmap(tmp_path, flag, value,
                                                   item):
    with pytest.raises(NotImplementedError, match=item):
        TrainNNPrepArea(tiny_cfg(tmp_path, **{flag: value}))


def test_unknown_ocr_and_missing_gpu_raise(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="unknown OCR"):
        TrainNNPrepArea(tiny_cfg(tmp_path, ocr="nope"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainNNPrepArea(tiny_cfg(tmp_path, device="cuda"))


@pytest.mark.slow
def test_one_epoch_beside_the_jax_trainer(tmp_path):
    """An epoch of both trainers from the same weights, no selection (every
    crop queried), the same numpy jitter: the ledgers are equal and the
    epoch's losses agree within 5% (bfloat16 steps in two frameworks; a crop
    the fake OCR reads differently on one side moves the CRNN loss)."""
    from qea_ocr_tpu.train import area_trainer as jat
    from qea_ocr_tpu_torch.tools.convert import (
        crnn_state_dict, unet_state_dict)
    from _torch_parity import jax_variables

    cfg = tiny_cfg(tmp_path / "t", epochs=1, minibatch_subset=None)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "device"}
    kw["exp_base_path"] = str(tmp_path / "j")
    jtrainer = jat.TrainNNPrepArea(jat.AreaTrainerConfig(**kw))
    trainer = TrainNNPrepArea(cfg)
    trainer.prep_model.load_state_dict(
        unet_state_dict(jax_variables(jtrainer.prep_state)))
    trainer.crnn_model.load_state_dict(
        crnn_state_dict(jax_variables(jtrainer.crnn_state)))
    jtrainer.train()
    trainer.train()
    jrec, trec = _records(tmp_path / "j")[0], _records(tmp_path / "t")[0]
    assert list(trec) == list(jrec)
    for key in ("Black-Box Calls", "Total CRNN Updates"):
        assert trec[key] == jrec[key], key
    for key in ("train_loss", "val_loss", "CRNN_loss"):
        assert trec[key] == pytest.approx(jrec[key], rel=5e-2), key
