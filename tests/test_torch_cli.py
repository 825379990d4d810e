"""The port's patch-training CLI (`qea_ocr_tpu_torch/cli/patch_cli.py`): its
flags are the JAX CLI's, flag for flag, plus `--device`; and `main` runs the
trainer end to end on the synthetic world (the arguments of the JAX
package's `tests/test_cli.py`)."""

import dataclasses
import glob
import json
import os

import pytest

from qea_ocr_tpu.cli import patch_cli as jcli
from qea_ocr_tpu.train.patch_trainer import PatchTrainerConfig as JConfig
from qea_ocr_tpu_torch.cli import patch_cli as tcli
from qea_ocr_tpu_torch.train.patch_trainer import PatchTrainerConfig

import _torch_parity  # noqa: F401  (one torch thread)


def _flags(parser):
    out = {}
    for a in parser._actions:
        if a.dest == "help":
            continue
        out[a.dest] = dict(
            options=tuple(a.option_strings), default=a.default, type=a.type,
            nargs=a.nargs, kind=type(a).__name__,
            choices=None if a.choices is None else tuple(a.choices))
    return out


def test_flags_equal_the_jax_cli():
    j, t = _flags(jcli.build_parser()), _flags(tcli.build_parser())
    assert t.pop("device")["default"] == "cuda"
    assert list(t) == list(j)                  # the same flags, in order
    for dest in j:
        assert t[dest] == j[dest], dest


def test_config_fields_equal_the_jax_config():
    j = {f.name: f.default for f in dataclasses.fields(JConfig)}
    t = {f.name: f.default for f in dataclasses.fields(PatchTrainerConfig)}
    assert t.pop("device") == "cuda"
    assert t == j


ARGV = ["--ocr", "Fake", "--dataset", "synthetic", "--epoch", "1",
        "--synthetic_train_docs", "4", "--synthetic_val_docs", "2",
        "--synthetic_strips_per_doc", "3", "--max_strips", "4",
        "--batch_docs", "2", "--doc_size", "96", "128",
        "--minibatch_subset", "rangeCER", "--minibatch_subset_prop", "0.5",
        "--inner_limit", "2", "--inner_limit_skip", "--window_size", "2",
        "--lstm_hidden", "32", "--unet_features", "8"]


def test_arguments_reach_the_config_as_in_the_jax_cli(tmp_path):
    argv = ARGV + ["--exp_base_path", str(tmp_path), "--no-async_ocr",
                   "--update_CRNN", "--prep_ema", "0.9", "--random_std",
                   "--micro_steps", "2", "--weightgen_method", "levenshtein"]
    j = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    t = tcli.config_from_args(tcli.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    assert t.device == "cpu"
    for f in dataclasses.fields(JConfig):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.async_ocr is False and t.random_std is False and t.epochs == 1


def test_main_trains_on_the_synthetic_world(tmp_path, capsys):
    tcli.main(ARGV + ["--exp_base_path", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Training Completed." in out and "Epoch BB calls - 16" in out
    assert os.path.exists(tmp_path / "params.txt")
    with open(tmp_path / "metrics.jsonl") as f:
        rec = json.loads(f.readline())
    # ceil(3 * (1 - 0.5)) = 2 strips a document x 4 documents x 2 inner
    # rounds = 16 training calls; validation reads all 2 x 3 strips
    assert rec["Black-Box Calls"] == 16
    assert rec["Train + Val BB Calls"] == 16 + 6
    assert glob.glob(str(tmp_path / "ckpts" / "Prep_model_0_*"))


def test_unported_flags_parse_and_then_raise(tmp_path):
    base = ARGV + ["--exp_base_path", str(tmp_path), "--device", "cpu"]
    for extra in (["--data_parallel"], ["--tensor_parallel", "2"],
                  ["--pruning_artifact", "p.json"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tcli.main(base + extra)
