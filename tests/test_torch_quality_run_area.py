"""The port's area quality runner
(`qea_ocr_tpu_torch/tools/quality_run_area.py`): its knobs are those of
`scripts/quality_run_area.py`, read from that script's source, with the same
defaults and the same refusal; and a tiny run of the area training and the
evaluation on the CPU, from a saved CRNN, writes its summary with the exact
query ledger."""

import ast
import json
import os
import tempfile
from pathlib import Path

import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread)
from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.tools import quality_run_area
from qea_ocr_tpu_torch.utils.charmap import CharMap
from qea_ocr_tpu_torch.utils.io import save_checkpoint

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / \
    "quality_run_area.py"

# the script's environment knob -> the port's field, and how the script
# turns the string it reads into a value
FIELDS = {
    "CORRUPTION": ("corruption", json.loads),
    # the script's fixed /tmp is the port's temporary directory
    "QUALITY_OUT": ("out", lambda v: os.path.join(
        tempfile.gettempdir(), os.path.relpath(v, "/tmp"))),
    "BUDGET_PROP": ("budget_prop", float),
    "TRAIN_SIZE": ("train_size", int),
    "VAL_SIZE": ("val_size", int),
    "EVAL_SIZE": ("eval_size", int),
    "LR_SCHED_PREP": ("lr_sched_prep", lambda v: v or None),
    "WARM_EPOCHS": ("warm_epochs", int),
    "WARMUP_OCR": ("warmup_ocr", str),
    "CRNN_CKPT": ("crnn_ckpt", lambda v: v),
    "AREA_EPOCHS": ("area_epochs", int),
    "PREP_PRETRAIN": ("prep_pretrain", int),
    "PREP_EMA": ("prep_ema", float),
    "LR_PREP": ("lr_prep", float),
    "LR_CRNN": ("lr_crnn", float),
    "SCALAR": ("scalar", float),
}


def _script_defaults() -> dict:
    """Every `os.environ.get(NAME[, default])` of the JAX script, by name."""
    found = {}
    for node in ast.walk(ast.parse(SCRIPT.read_text())):
        if isinstance(node, ast.Call) and ast.unparse(node.func) == \
                "os.environ.get":
            name = ast.literal_eval(node.args[0])
            found[name] = ast.literal_eval(node.args[1]) \
                if len(node.args) > 1 else None
    return found


def test_default_knobs_are_the_scripts():
    defaults = _script_defaults()
    assert set(defaults) == set(FIELDS)
    k = quality_run_area.read_knobs({})
    assert {f.name for f in quality_run_area.dataclasses.fields(k)} == {
        field for field, _ in FIELDS.values()}
    for name, default in defaults.items():
        field, convert = FIELDS[name]
        want = None if default is None else convert(default)
        assert getattr(k, field) == want, name
    k = quality_run_area.read_knobs({"LR_SCHED_PREP": "cosine",
                                     "PREP_EMA": "0.995",
                                     "CRNN_CKPT": "/x/model_3"})
    assert (k.lr_sched_prep, k.prep_ema, k.crnn_ckpt) == ("cosine", 0.995,
                                                          "/x/model_3")


@pytest.mark.parametrize("value", ["linear", "Cosine", "step"])
def test_refused_knobs(value):
    """The script refuses any learning-rate schedule of the prep but cosine
    when it reads its knobs, before the warmup."""
    with pytest.raises(SystemExit, match="LR_SCHED_PREP"):
        quality_run_area.read_knobs({"LR_SCHED_PREP": value})


def test_tiny_area_run_on_the_cpu(tmp_path, monkeypatch):
    """Full-width models (the runner has no width knobs) from a saved CRNN
    with seeded random weights, so no warmup: 64 training crops (the
    script's batch; a partial training batch is dropped) and 8 validation
    crops, one pretraining and one area epoch, 8 evaluation crops."""
    crnn_path = tmp_path / "crnn_model"
    save_checkpoint(str(crnn_path), CRNN(CharMap.default().vocab_size,
                                         generator=torch.Generator()
                                         .manual_seed(0)))
    out = tmp_path / "q"
    env = dict(QUALITY_OUT=str(out), CRNN_CKPT=str(crnn_path),
               TRAIN_SIZE="64", VAL_SIZE="8", EVAL_SIZE="8", AREA_EPOCHS="1",
               PREP_PRETRAIN="1", LR_SCHED_PREP="cosine", PREP_EMA="0.995")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    summary = quality_run_area.main(["--device", "cpu"])
    with open(out / "summary.json") as f:
        assert json.load(f) == summary
    assert set(summary) == {
        "cleaned_acc", "cleaned_cer", "best_train_val_acc", "budget",
        "total_seconds", "original_acc", "original_cer", "best_epoch",
        "train_bb_calls", "total_bb_calls", "device"}
    # rangeCER at 0.75: ceil(64 x 0.25) = 16 crops, queried clean and
    # jittered; validation reads all 8
    assert summary["train_bb_calls"] == 16 * 2
    assert summary["total_bb_calls"] == 16 * 2 + 8
    assert summary["budget"] == 0.25 and summary["device"] == "cpu"
    for key in ("cleaned_acc", "cleaned_cer", "original_acc",
                "original_cer"):
        assert 0.0 <= summary[key] <= 1.0 + 1e-6, key
    assert not os.path.exists(out / "crnn")
    assert os.path.exists(out / "area" / "metrics.jsonl")
