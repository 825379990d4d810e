"""The port's quality runner (`qea_ocr_tpu_torch/tools/quality_run.py`): its
knobs are those of `scripts/quality_run.py`, with the same defaults and the
same refusals; it never picks an optimizer file as a checkpoint; and a tiny
run of the whole pipeline (warmup, CER seed, patch training, evaluation) on
the CPU writes its summary with the exact training query ledger."""

import json
import os
import time

import pytest

import _torch_parity  # noqa: F401  (one torch thread)
from qea_ocr_tpu_torch.tools import quality_run


def test_default_knobs_are_the_scripts():
    k = quality_run.read_knobs({})
    assert (k.budget_prop, k.strips_per_doc, k.doc_size, k.selection,
            k.weightgen, k.train_docs, k.val_docs, k.eval_docs, k.warm_size,
            k.batch_docs, k.micro_steps, k.step_match) == (
        0.75, 8, (400, 512), "rangeCER", "decaying", 256, 16, 16, 4096, 8,
        1, True)
    assert (k.lr_prep, k.lr_crnn) == (5e-5, 1e-4)
    assert k.warmup_corruption == dict(noise_std=0.14, shading=0.18,
                                       salt_pepper=0.007)
    k = quality_run.read_knobs({"MICRO_STEPS": "2", "BATCH_DOCS": "2",
                                "LR_SCALE": "2"})
    assert (k.micro_steps, k.step_match, k.lr_prep) == (2, False, 1e-4)


@pytest.mark.parametrize("env", [
    {"SELECTION": "nope"}, {"WEIGHTGEN": "nope"},
    {"MICRO_STEPS": "3", "BATCH_DOCS": "8"},
    {"DOC_SIZE": "96,128", "STRIPS_PER_DOC": "8"}])
def test_refused_knobs(env):
    with pytest.raises(SystemExit):
        quality_run.read_knobs(env)


def test_newest_checkpoint_skips_the_optimizer_file(tmp_path):
    for name in ("model_0_1.00", "model_1_2.00", "model_1_2.00.optim"):
        (tmp_path / name).write_text(name)
        time.sleep(0.01)
    got = quality_run.newest_checkpoint(str(tmp_path / "model_*"))
    assert got == str(tmp_path / "model_1_2.00")
    assert quality_run.newest_checkpoint(str(tmp_path / "none_*")) is None


TINY = dict(WARM_SIZE="16", WARM_EPOCHS="1", PATCH_EPOCHS="1",
            PREP_PRETRAIN="1", BATCH_DOCS="2", TRAIN_DOCS="2", VAL_DOCS="2",
            EVAL_DOCS="3", STRIPS_PER_DOC="3", DOC_SIZE="96,128",
            CERS_SEED="1")


def test_tiny_pipeline_on_the_cpu(tmp_path, monkeypatch):
    """Full-width models (the runner has no width knobs) on 2 training
    documents of 96x128 with 3 strips, one epoch of each phase."""
    out = tmp_path / "q"
    for k, v in dict(TINY, QUALITY_OUT=str(out)).items():
        monkeypatch.setenv(k, v)
    for k in ("CRNN_CKPT", "CERS_OCR_PATH", "STEP_MATCH", "MICRO_STEPS"):
        monkeypatch.delenv(k, raising=False)
    summary = quality_run.main(["--device", "cpu"])
    with open(out / "summary.json") as f:
        assert json.load(f) == summary
    # 2 documents x ceil(3 x 0.25) = 1 strip, queried clean and jittered;
    # validation reads 2 x 3 strips; the seed pass 2 x 3 offline
    assert summary["train_bb_calls"] == 2 * 1 * 2
    assert summary["train_val_bb_calls"] == 2 * 1 * 2 + 2 * 3
    assert summary["seed_bb_calls"] == 6
    assert summary["budget"] == 0.25 and summary["device"] == "cpu"
    for key in ("cleaned_acc", "cleaned_cer", "original_acc",
                "original_cer", "warmup_best_acc"):
        assert 0.0 <= summary[key] <= 1.0 + 1e-6, key
    assert os.path.exists(out / "crnn" / "metrics.jsonl")
    assert os.path.exists(out / "cers_seed.json")
