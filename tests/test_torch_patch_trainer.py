"""The port's patch trainer (`qea_ocr_tpu_torch/train/patch_trainer.py`) on a
tiny synthetic world with the fake OCR, on the CPU: the query ledger against
the budget formula, the side JSONs, checkpoints and resume, sync against
async OCR, the channel-major twin, and a checkpoint carried into the JAX
model through the JAX package's `tools/import_torch.py`.

One test, marked `slow`, runs a whole epoch of the JAX trainer beside the
port's from the same weights (it compiles the JAX package's fused step).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from qea_ocr_tpu_torch.train.patch_trainer import (
    PatchTrainerConfig, TrainNNPrep)
from qea_ocr_tpu_torch.utils.io import OPTIM_SUFFIX, load_checkpoint

DOCS, VAL_DOCS, STRIPS = 4, 2, 3


def tiny_cfg(tmp, **overrides):
    base = dict(
        device="cpu", epochs=2, ocr="Fake", dataset="synthetic",
        synthetic_train_docs=DOCS, synthetic_val_docs=VAL_DOCS,
        synthetic_strips_per_doc=STRIPS, max_strips=4, batch_docs=2,
        doc_size=(96, 128),
        corruption=dict(noise_std=0.08, shading=0.1, salt_pepper=0.0),
        inner_limit=2, inner_limit_skip=True, window_size=2,
        weightgen_method="decaying", lstm_hidden=32, unet_features=8,
        exp_base_path=str(tmp))
    base.update(overrides)
    return PatchTrainerConfig(**base)


def _records(tmp):
    with open(os.path.join(str(tmp), "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _ckpt(tmp, pattern):
    return sorted(p for p in glob.glob(os.path.join(str(tmp), "ckpts",
                                                    pattern))
                  if not p.endswith(OPTIM_SUFFIX))


# per document ceil(3 * (1 - 0.5)) = 2 strips queried, once clean and once
# jittered (inner_limit 2 with skip): 4 documents x 2 x 2 = 16 an epoch;
# validation reads all 2 x 3 strips
TRAIN_CALLS, VAL_CALLS = DOCS * 2 * 2, VAL_DOCS * STRIPS


@pytest.fixture(scope="module")
def run_range_cer(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("patch")
    trainer = TrainNNPrep(tiny_cfg(tmp, minibatch_subset="rangeCER",
                                   minibatch_subset_prop=0.5, window_size=3))
    best_acc, best_epoch = trainer.train()
    return trainer, best_acc, best_epoch, tmp


def test_query_ledger_equals_the_budget(run_range_cer):
    trainer, _, _, tmp = run_range_cer
    assert trainer.ocr.total_calls == 2 * (TRAIN_CALLS + VAL_CALLS)
    recs = _records(tmp)
    assert len(recs) == 2
    for i, rec in enumerate(recs):
        assert rec["Black-Box Calls"] == TRAIN_CALLS
        assert rec["Total Black-Box Calls"] == TRAIN_CALLS * (i + 1)
        assert rec["Train + Val BB Calls"] == TRAIN_CALLS + VAL_CALLS
        assert rec["Total Train + Val BB Calls"] == \
            (TRAIN_CALLS + VAL_CALLS) * (i + 1)
        assert rec["CRNN Updates"] == 2 and rec["Epoch"] == i + 1
        for key in ("CRNN_accuracy", "Fake_accuracy", "CRNN_CER", "Fake_cer",
                    "train_loss", "val_loss", "CRNN_loss",
                    "CRNN_OCR_Matching_ACC", "CRNN_OCR_Matching_CER",
                    "time/phase_ab_mean_s", "time/epoch_s"):
            assert np.isfinite(rec[key]), key


def test_stage_keys_are_those_of_the_jax_trainer(run_range_cer):
    """The stages this run went through, under the JAX trainer's names
    (`tests/test_torch_stage_names.py` holds the names themselves)."""
    _, _, _, tmp = run_range_cer
    for rec in _records(tmp):
        for stage in ("prep_extract", "ocr_issue", "ocr_wait", "phase_ab"):
            for stat in ("mean_s", "total_s"):
                assert np.isfinite(rec[f"time/{stage}_{stat}"]), stage
        assert not [k for k in rec if k.startswith("time/ocr_submit")]


def test_history_and_tables_written_for_the_right_strips(run_range_cer):
    trainer, _, _, tmp = run_range_cer
    ds = trainer.dataset
    with open(tmp / "selected_samples" / "selected_samples_current.json") as f:
        selected = json.load(f)
    assert all(len(v) == 2 for v in selected.values())
    assert sum(sum(v) for v in selected.values()) == 2 * DOCS * 2
    with open(tmp / "tracked_labels" / "tracked_labels_current.json") as f:
        tracked = json.load(f)
    # history exists for the queried strips and for no other
    queried = {n for n, v in selected.items() if any(v)}
    assert set(tracked) == queried
    for name, texts in tracked.items():
        sid = ds.name_to_id[name]
        assert len(texts) == sum(selected[name]) == trainer.history.counts[sid]
    assert (trainer.history.counts > 0).sum() == len(queried)
    assert os.path.exists(tmp / "tracked_labels" / "tracked_labels_1.json")
    # the CER table: one entry per valid strip and epoch; the table itself
    # moved at valid strips' ids only
    with open(tmp / "cers" / "all_cers.json") as f:
        cers = json.load(f)
    valid_names = {n for s in ds.samples
                   for n, m in zip(s.strip_names, s.strip_mask) if m}
    assert set(cers) == valid_names and len(cers) == DOCS * STRIPS
    assert all(len(v) == 2 and min(v) >= 0 for v in cers.values())
    table = trainer.cer_table.numpy()
    valid_ids = sorted(ds.name_to_id[n] for n in valid_names)
    np.testing.assert_allclose(
        table[valid_ids], [cers[ds.id_to_name[i]][-1] for i in valid_ids],
        rtol=1e-6)
    others = np.setdiff1d(np.arange(ds.num_strips), valid_ids)
    assert (table[others] == 1.0).all()
    assert (trainer.ent_table.numpy()[valid_ids] != 1.0).any()


def test_checkpoints_images_and_summary(run_range_cer):
    trainer, best_acc, best_epoch, tmp = run_range_cer
    names = {os.path.basename(p) for p in glob.glob(str(tmp / "ckpts" / "*"))}
    assert any(n.startswith("Prep_model_0_") for n in names)
    assert {"CRNN_model_0", "CRNN_model_1",
            "CRNN_model_1" + OPTIM_SUFFIX} <= names
    if best_acc > 0:
        assert "Prep_model_best" in names
        assert trainer.logger.summary["best_val_epoch"] == best_epoch
    for png in ("out_0.png", "out_1.png", "out_original.png"):
        with open(tmp / "img_out" / png, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    # a checkpoint is the model's state, as plain tensors
    sd = torch.load(_ckpt(tmp, "Prep_model_1_*")[0], weights_only=True)
    assert list(sd) == list(trainer.prep_model.state_dict())
    for k, v in trainer.prep_model.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_sync_ocr_gives_the_same_ledger(run_range_cer, tmp_path):
    trainer = TrainNNPrep(tiny_cfg(
        tmp_path, minibatch_subset="rangeCER", minibatch_subset_prop=0.5,
        window_size=3, async_ocr=False))
    trainer.train()
    assert trainer.ocr.total_calls == run_range_cer[0].ocr.total_calls
    a, b = _records(tmp_path), _records(run_range_cer[3])
    for ra, rb in zip(a, b):
        for key in ("Black-Box Calls", "Total Train + Val BB Calls",
                    "CRNN Updates"):
            assert ra[key] == rb[key]
    # the first step of the run sees the same strips either way
    assert np.isfinite(a[-1]["train_loss"])


@pytest.mark.parametrize("subset,window,calls", [
    (None, 1, DOCS * STRIPS * 2),           # no selection: every strip
    ("uniformCERglobal", 1, 6 * 2),         # round(0.5 * 12) strips an epoch
    ("topKCER", 3, TRAIN_CALLS),
    ("uniformEntropy", 1, TRAIN_CALLS),
])
def test_selection_methods_and_windows(tmp_path, subset, window, calls):
    trainer = TrainNNPrep(tiny_cfg(
        tmp_path, epochs=1, minibatch_subset=subset,
        minibatch_subset_prop=0.5, window_size=window))
    trainer.train()
    rec = _records(tmp_path)[0]
    assert rec["Black-Box Calls"] == calls
    assert rec["Train + Val BB Calls"] == calls + VAL_CALLS
    assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"])
    if subset == "uniformCERglobal":
        assert trainer.global_bitmap.sum() == 6
    if subset is None:
        assert not os.path.exists(tmp_path / "cers" / "all_cers.json")


@pytest.mark.parametrize("method,extra", [
    ("levenshtein", {}), ("self_attention", dict(emb_dim=16, query_dim=8))])
def test_samplewise_weight_generators(tmp_path, method, extra):
    trainer = TrainNNPrep(tiny_cfg(
        tmp_path, epochs=1, minibatch_subset="random", window_size=2,
        weightgen_method=method, **extra))
    best_acc, _ = trainer.train()
    assert 0.0 <= best_acc <= 1.0
    assert np.isfinite(_records(tmp_path)[0]["CRNN_loss"])


def test_warmup_phase_b_only_and_validation_tail(tmp_path):
    # a warm-up epoch queries every valid strip; inner_limit 0 trains the
    # UNet alone; 3 validation documents leave a tail batch of one
    t = TrainNNPrep(tiny_cfg(tmp_path / "a", minibatch_subset="rangeCER",
                             warmup_epochs=1, epochs=1, inner_limit=1))
    t.train()
    assert t.ocr.epoch_calls == DOCS * STRIPS + VAL_CALLS
    crnn0 = {k: v.clone() for k, v in
             TrainNNPrep(tiny_cfg(tmp_path / "c")).crnn_model.state_dict().items()}
    t = TrainNNPrep(tiny_cfg(tmp_path / "b", epochs=1, inner_limit=0,
                             synthetic_val_docs=3))
    t.train()
    rec = _records(tmp_path / "b")[0]
    assert rec["Black-Box Calls"] == 0 and rec["CRNN Updates"] == 0
    assert rec["Train + Val BB Calls"] == 3 * STRIPS
    assert np.isfinite(rec["val_loss"]) and rec["val_loss"] < 1e3
    for k, v in t.crnn_model.state_dict().items():
        assert torch.equal(v, crnn0[k]), k          # the CRNN never moved


def test_resume_from_checkpoints_and_side_state(tmp_path):
    first = TrainNNPrep(tiny_cfg(tmp_path / "a", epochs=1,
                                 minibatch_subset="rangeCER"))
    first.train()
    prep_ck = _ckpt(tmp_path / "a", "Prep_model_0_*")[0]
    crnn_ck = str(tmp_path / "a" / "ckpts" / "CRNN_model_0")
    tracked = str(tmp_path / "a" / "tracked_labels"
                  / "tracked_labels_current.json")
    cers = {n: v[-1] for n, v in first.all_cers.items()}
    (tmp_path / "cers.json").write_text(json.dumps(cers))

    # model-only warm start: fresh optimizers, history and CER priors back
    second = TrainNNPrep(tiny_cfg(
        tmp_path / "b", epochs=2, start_epoch=1, prep_model=prep_ck,
        crnn_model=crnn_ck, tracked_labels_path=tracked,
        cers_ocr_path=str(tmp_path / "cers.json"),
        minibatch_subset="topKCER", lr_crnn=3e-4))
    for k, v in first.prep_model.state_dict().items():
        assert torch.equal(second.prep_model.state_dict()[k], v), k
    assert second.prep_model.shares_state(second.prep_eval_model)
    assert not second.prep_optimizer.state_dict()["state"]
    np.testing.assert_array_equal(second.history.counts, first.history.counts)
    np.testing.assert_array_equal(second.history.labels, first.history.labels)
    for name, cer in cers.items():
        assert abs(float(second.cer_table[second.dataset.name_to_id[name]])
                   - cer) < 1e-6
    assert set(cers) <= set(second.selected_samples)
    best_acc, _ = second.train()
    assert 0.0 <= best_acc <= 1.0
    recs = _records(tmp_path / "b")
    assert len(recs) == 1 and recs[0]["Epoch"] == 2
    assert (second.history.counts >= first.history.counts).all()
    assert second.history.counts.sum() > first.history.counts.sum()

    # full-state resume: Adam's moments come back, the configured rate wins
    third = TrainNNPrep(tiny_cfg(
        tmp_path / "c", epochs=2, start_epoch=1, optim_prep_path=prep_ck,
        optim_crnn_path=crnn_ck, lr_crnn=3e-4))
    state = third.crnn_optimizer.state_dict()
    assert state["state"] and state["param_groups"][0]["lr"] == 3e-4
    want = first.crnn_optimizer.state_dict()["state"]
    for i, s in state["state"].items():
        assert torch.equal(s["exp_avg"], want[i]["exp_avg"])
        assert float(s["step"]) == float(want[i]["step"]) == 2.0


def test_prep_ema_is_what_validation_and_checkpoints_see(tmp_path):
    trainer = TrainNNPrep(tiny_cfg(tmp_path, minibatch_subset="rangeCER",
                                   prep_ema=0.9))
    trainer.train()
    raw = [p.detach().clone() for p in trainer.prep_model.parameters()]
    diffs = [float((a - b).abs().max())
             for a, b in zip(raw, trainer.ema_params)]
    assert max(diffs) > 0.0                  # the EMA lags the raw weights
    loaded = TrainNNPrep(tiny_cfg(tmp_path / "x")).prep_model
    load_checkpoint(_ckpt(tmp_path, "Prep_model_1_*")[0], loaded)
    for a, b in zip(loaded.parameters(), trainer.ema_params):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
    # the swap is undone: training goes on from the raw weights
    for a, b in zip(trainer.prep_model.parameters(), raw):
        assert torch.equal(a, b)


def test_prep_pretrain_reduces_reconstruction_error(tmp_path):
    trainer = TrainNNPrep(tiny_cfg(tmp_path, epochs=1, inner_limit=0,
                                   prep_pretrain_epochs=4))
    from qea_ocr_tpu_torch.data import collate_docs
    images = torch.from_numpy(collate_docs(
        [trainer.dataset[0], trainer.dataset[1]]).images)

    def mse():
        trainer.prep_model.eval()
        with torch.no_grad():
            return float(((trainer.prep_model(images) - images) ** 2).mean())
    before = mse()
    trainer._prep_pretrain()
    assert mse() < before
    assert trainer.prep_optimizer.param_groups[0]["lr"] == trainer.cfg.lr_prep


def test_conv_impl_env_reroutes_the_twin_only(tmp_path, monkeypatch):
    """`QEA_CONV_IMPL=cmajor`: the grad model stays on the library route,
    the twin takes the channel-major route (8 flat convs a forward) for
    `prep_extract` and `val_forward`, and the ledger is the same."""
    from qea_ocr_tpu_torch.models import unet as unet_mod

    flat_convs = []
    real = unet_mod.conv_flat_bn_relu
    monkeypatch.setattr(unet_mod, "conv_flat_bn_relu",
                        lambda *a: flat_convs.append(1) or real(*a))
    monkeypatch.setenv("QEA_CONV_IMPL", "cmajor")
    trainer = TrainNNPrep(tiny_cfg(tmp_path, epochs=1,
                                   minibatch_subset="rangeCER"))
    monkeypatch.delenv("QEA_CONV_IMPL")
    assert trainer.prep_model.conv_impl == "xla"
    assert trainer.prep_eval_model.conv_impl == "cmajor"
    assert trainer.prep_model.shares_state(trainer.prep_eval_model)
    n_opt = sum(len(g["params"]) for g in trainer.prep_optimizer.param_groups)
    assert n_opt == len(list(trainer.prep_model.parameters()))
    trainer.train()
    # 2 training batches and 1 validation batch, 8 convs each
    assert len(flat_convs) == 8 * 3
    rec = _records(tmp_path)[0]
    assert rec["Black-Box Calls"] == TRAIN_CALLS
    assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"])


def test_pruning_artifact_selects_the_training_documents(tmp_path):
    """`pruning_artifact` wins over `train_subset_size` and gives the
    documents the JAX package's `pruning_indices` gives on the same ones."""
    from qea_ocr_tpu.data.datasets import PatchDocuments as JDocs
    from qea_ocr_tpu.pruning.prune import pruning_indices as j_indices

    cfg = tiny_cfg(tmp_path)
    jdocs = JDocs.synthetic(DOCS, seed=cfg.random_seed,
                            n_strips=STRIPS, max_strips=4,
                            corruption=cfg.corruption, doc_size=(96, 128))
    keys = [s.doc_name.replace(os.sep, "_") for s in jdocs.samples]
    art = tmp_path / "pruned.json"
    art.write_text(json.dumps({keys[3]: 0.9, keys[1]: 0.5}))
    trainer = TrainNNPrep(tiny_cfg(tmp_path, pruning_artifact=str(art),
                                   train_subset_size=1))
    want = j_indices(jdocs, str(art))
    np.testing.assert_array_equal(trainer.train_indices, want)
    np.testing.assert_array_equal(trainer.train_indices, [1, 3])
    assert trainer.train_set_size == 2
    np.testing.assert_array_equal(trainer._local_train_indices, [1, 3])


def test_parallel_flags_without_a_process_group(tmp_path):
    """`data_parallel` without a process group is a world of one (the
    single-process steps); `tensor_parallel` needs a group; the micro-step
    chunk must divide over the data axis (checked with a world of one)."""
    trainer = TrainNNPrep(tiny_cfg(tmp_path, data_parallel=True))
    assert (trainer.group, trainer._pc, trainer._world) == (None, 1, 1)
    assert trainer._dl == trainer.cfg.batch_docs
    with pytest.raises(ValueError, match="needs a process group"):
        TrainNNPrep(tiny_cfg(tmp_path, tensor_parallel=2))


def test_missing_ocr_engine_and_gpu_raise(tmp_path, monkeypatch):
    with pytest.raises(ImportError, match="tesserocr"):
        TrainNNPrep(tiny_cfg(tmp_path, ocr="Tesseract"))
    with pytest.raises(ValueError, match="unknown OCR"):
        TrainNNPrep(tiny_cfg(tmp_path, ocr="nope"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainNNPrep(tiny_cfg(tmp_path, device="cuda"))
    with pytest.raises(ValueError, match="micro_steps"):
        TrainNNPrep(tiny_cfg(tmp_path, micro_steps=3, batch_docs=2))


def test_micro_steps_take_more_updates(tmp_path):
    trainer = TrainNNPrep(tiny_cfg(tmp_path, epochs=1, micro_steps=2,
                                   micro_refresh=True,
                                   minibatch_subset="rangeCER"))
    trainer.train()
    rec = _records(tmp_path)[0]
    assert rec["CRNN Updates"] == 4 and rec["Black-Box Calls"] == TRAIN_CALLS


def test_checkpoint_loads_into_the_jax_model(run_range_cer):
    """A prep checkpoint goes through the JAX package's importer
    (`tools/import_torch.py`) into the flax UNet; its eval output equals the
    port's within the bfloat16 layout tolerance (2e-3 on the sigmoid)."""
    import jax.numpy as jnp

    from qea_ocr_tpu.models import UNet as JUNet
    from qea_ocr_tpu.tools.import_torch import (
        convert_crnn, convert_unet, load_torch_state_dict)

    trainer, _, _, tmp = run_range_cer
    variables = convert_unet(load_torch_state_dict(
        _ckpt(tmp, "Prep_model_1_*")[0]))
    crnn_vars = convert_crnn(load_torch_state_dict(
        str(tmp / "ckpts" / "CRNN_model_1")))
    assert "OptimizedLSTMCell_0" in crnn_vars["params"]
    x = np.stack([trainer.validation_set[i].image for i in range(2)])[:, None]
    want = np.asarray(JUNet(init_features=8, conv_impl="xla").apply(
        variables, jnp.asarray(x), train=False))
    trainer.prep_model.eval()
    with torch.no_grad():
        got = trainer.prep_model(torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) < 2e-3


@pytest.mark.slow
def test_one_epoch_beside_the_jax_trainer(tmp_path):
    """A whole epoch of both trainers from the same weights, no selection
    (every strip queried, so no random ranks), synchronous OCR, the same
    numpy jitter: the ledgers are equal and the epoch's losses agree within
    5% (bfloat16 steps in two frameworks; a strip the fake OCR reads
    differently on one side moves the CRNN loss)."""
    import jax

    from qea_ocr_tpu.train import patch_trainer as jpt
    from qea_ocr_tpu_torch.tools.convert import (
        crnn_state_dict, unet_state_dict)
    from _torch_parity import jax_variables

    common = dict(epochs=1, minibatch_subset=None, async_ocr=False)
    kw = {k: v for k, v in dataclasses_asdict(
        tiny_cfg(tmp_path / "t", **common)).items()
          if k not in ("device", "proxy")}
    kw["exp_base_path"] = str(tmp_path / "j")
    jtrainer = jpt.TrainNNPrep(jpt.PatchTrainerConfig(**kw))
    prep_sd = unet_state_dict(jax_variables(jtrainer.prep_state))
    crnn_sd = crnn_state_dict(jax_variables(jtrainer.crnn_state))
    trainer = TrainNNPrep(tiny_cfg(tmp_path / "t", **common))
    trainer.prep_model.load_state_dict(prep_sd)
    trainer.crnn_model.load_state_dict(crnn_sd)
    jtrainer.train()
    trainer.train()
    jrec, trec = _records(tmp_path / "j")[0], _records(tmp_path / "t")[0]
    for key in ("Black-Box Calls", "Train + Val BB Calls", "CRNN Updates"):
        assert trec[key] == jrec[key], key
    for key in ("train_loss", "val_loss", "CRNN_loss"):
        assert trec[key] == pytest.approx(jrec[key], rel=5e-2), key
    del jax


def dataclasses_asdict(cfg):
    import dataclasses
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
