"""The port's training CLIs (`qea_ocr_tpu_torch/cli/patch_cli.py`,
`cli/area_cli.py`): their flags are the JAX CLIs', flag for flag, plus
`--device`; and `main` runs the trainer end to end on the synthetic world
(the arguments of the JAX package's `tests/test_cli.py`)."""

import dataclasses
import glob
import json
import os

import pytest

from qea_ocr_tpu.cli import area_cli as j_area_cli
from qea_ocr_tpu.cli import patch_cli as jcli
from qea_ocr_tpu.train.area_trainer import AreaTrainerConfig as JAreaConfig
from qea_ocr_tpu.train.patch_trainer import PatchTrainerConfig as JConfig
from qea_ocr_tpu_torch.cli import area_cli as t_area_cli
from qea_ocr_tpu_torch.cli import patch_cli as tcli
from qea_ocr_tpu_torch.train.area_trainer import AreaTrainerConfig
from qea_ocr_tpu_torch.train.patch_trainer import PatchTrainerConfig

from _torch_parity import parser_flags  # (and one torch thread)

ARGV = ["--ocr", "Fake", "--dataset", "synthetic", "--epoch", "1",
        "--synthetic_train_docs", "4", "--synthetic_val_docs", "2",
        "--synthetic_strips_per_doc", "3", "--max_strips", "4",
        "--batch_docs", "2", "--doc_size", "96", "128",
        "--minibatch_subset", "rangeCER", "--minibatch_subset_prop", "0.5",
        "--inner_limit", "2", "--inner_limit_skip", "--window_size", "2",
        "--lstm_hidden", "32", "--unet_features", "8"]
AREA_ARGV = ["--ocr", "Fake", "--dataset", "synthetic", "--epoch", "1",
             "--batch_size", "8", "--synthetic_train_size", "16",
             "--synthetic_val_size", "10", "--minibatch_subset", "topKCER",
             "--minibatch_subset_prop", "0.5", "--inner_limit", "2",
             "--inner_limit_skip", "--window_size", "2", "--lstm_hidden",
             "32", "--unet_features", "8"]
# (JAX CLI, port CLI, JAX config, port config, arguments, arguments that
# must reach the config)
CLIS = {
    "patch": (jcli, tcli, JConfig, PatchTrainerConfig, ARGV,
              ["--no-async_ocr", "--update_CRNN", "--prep_ema", "0.9",
               "--random_std", "--micro_steps", "2", "--weightgen_method",
               "levenshtein"]),
    "area": (j_area_cli, t_area_cli, JAreaConfig, AreaTrainerConfig,
             AREA_ARGV,
             ["--update_CRNN", "--prep_ema", "0.9", "--random_std",
              "--lr_scheduler", "cosine", "--lr_scheduler_prep", "cosine",
              "--prep_pretrain_epochs", "2", "--weightgen_method",
              "levenshtein"]),
}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_flags_equal_the_jax_cli(cli):
    jmod, tmod = CLIS[cli][:2]
    j, t = parser_flags(jmod.build_parser()), parser_flags(
        tmod.build_parser())
    assert t.pop("device")["default"] == "cuda"
    assert list(t) == list(j)                  # the same flags, in order
    for dest in j:
        assert t[dest] == j[dest], dest


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_config_fields_equal_the_jax_config(cli):
    jcfg, tcfg = CLIS[cli][2:4]
    j = {f.name: f.default for f in dataclasses.fields(jcfg)}
    t = {f.name: f.default for f in dataclasses.fields(tcfg)}
    assert t.pop("device") == "cuda"
    assert t == j


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_arguments_reach_the_config_as_in_the_jax_cli(cli, tmp_path):
    jmod, tmod, jcfg, _, argv, extra = CLIS[cli]
    argv = argv + ["--exp_base_path", str(tmp_path)] + extra
    j = jmod.config_from_args(jmod.build_parser().parse_args(argv))
    t = tmod.config_from_args(tmod.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    assert t.device == "cpu"
    for f in dataclasses.fields(jcfg):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.update_CRNN is True and t.random_std is False and t.epochs == 1
    if cli == "patch":
        assert t.async_ocr is False


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


def test_area_main_trains_on_the_synthetic_world(tmp_path, capsys):
    t_area_cli.main(AREA_ARGV + ["--exp_base_path", str(tmp_path),
                                 "--device", "cpu"])
    assert "Training Completed." in capsys.readouterr().out
    assert os.path.exists(tmp_path / "params.txt")
    with open(tmp_path / "metrics.jsonl") as f:
        rec = json.loads(f.readline())
    # ceil(8 * (1 - 0.5)) = 4 crops a batch x 2 batches x 2 inner rounds
    assert rec["Black-Box Calls"] == rec["Total Black-Box Calls"] == 16
    assert glob.glob(str(tmp_path / "ckpts" / "Prep_model_0_*"))


def test_unported_flags_parse_and_then_raise(tmp_path):
    base = ["--exp_base_path", str(tmp_path), "--device", "cpu"]
    for main, argv in ((tcli.main, ARGV + ["--data_parallel"]),
                       (tcli.main, ARGV + ["--tensor_parallel", "2"]),
                       (tcli.main, ARGV + ["--pruning_artifact", "p.json"]),
                       (t_area_cli.main, AREA_ARGV + ["--data_parallel"])):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main(base + argv)
