"""The port's GPU launchers (`qea_ocr_tpu_torch/launch/*.sh`) and console
scripts (`pyproject.toml` `[project.scripts]`).

Each launcher is run with a stub `python` and `torchrun` first on `PATH`
that record their arguments instead of running anything, beside the JAX
package's script of the same name (`scripts/`), which gets the same stub.
The module each calls must be the port's, its flags must parse with that
module's own parser, and its fixed flags and environment defaults must be
the JAX script's, apart from the module and `--device`."""

import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
LAUNCH = ROOT / "qea_ocr_tpu_torch" / "launch"
SCRIPTS = ROOT / "scripts"
NAMES = ("run_patch_training.sh", "run_area_training.sh",
         "run_crnn_warmup.sh", "run_crnn_eval.sh", "run_prep_eval.sh",
         "run_sweep_array.sh")
# the launchers whose CLI takes --data_parallel, and so NPROC
PARALLEL = ("run_patch_training.sh", "run_area_training.sh",
            "run_crnn_warmup.sh")
# "$@": checkpoints for the evaluation loops, a flag for the others
EXTRA = {"run_crnn_eval.sh": ["ck/a", "ck/b"],
         "run_prep_eval.sh": ["ck/a", "ck/b"]}
STUB = """#!/bin/sh
exec "{python}" -c 'import json, sys
with open(sys.argv[1], "a") as f:
    f.write(json.dumps([sys.argv[2]] + sys.argv[3:]) + "\\n")' "{record}" \
"{name}" "$@"
"""
STAMP = re.compile(r"_\d{8}_\d{6}$")


def _repaired(name: str, flags: list) -> list:
    """The JAX script's flags as the port's launcher repairs them: its
    `run_crnn_eval.sh` passes a checkpoint as `--crnn_path` alone, which its
    own CLI refuses (`--crnn_model_name` is required); the port's passes the
    checkpoint's directory and name."""
    if name != "run_crnn_eval.sh":
        return flags
    i = flags.index("--crnn_path")
    head, tail = os.path.split(flags[i + 1])
    return flags[:i] + ["--crnn_path", head, "--crnn_model_name",
                        tail] + flags[i + 2:]


def _record(script: Path, tmp: Path, env: dict, extra: list) -> list:
    """Run `script` from `tmp` with the stubs first on PATH; -> the argv of
    each call of `python` or `torchrun`, the program's name first."""
    bin_dir, record = tmp / "bin", tmp / "calls.jsonl"
    bin_dir.mkdir(exist_ok=True)
    record.unlink(missing_ok=True)
    for name in ("python", "torchrun"):
        stub = bin_dir / name
        stub.write_text(STUB.format(python=sys.executable, record=record,
                                    name=name))
        stub.chmod(0o755)
    run_env = {k: v for k, v in os.environ.items()
               if k not in ("DATA", "EXP", "OUT", "OCR", "BUDGET_PROP", "N",
                            "DB", "DEVICE", "NPROC")}
    run_env.update(env, PATH=f"{bin_dir}:{os.environ['PATH']}")
    proc = subprocess.run(["bash", str(script), *extra], cwd=tmp,
                          env=run_env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    with open(record) as f:
        return sorted((json.loads(line) for line in f), key=json.dumps)


def _parser(module: str):
    mod = importlib.import_module(module)
    return mod.build_parser()


def _module_and_flags(call: list) -> tuple:
    """(module, its argv) of one recorded `python -m` or `torchrun ... -m`
    call."""
    i = call.index("-m")
    return call[i + 1], call[i + 2:]


def _without_device(flags: list) -> list:
    i = flags.index("--device")
    return flags[:i] + flags[i + 2:]


@pytest.mark.parametrize("name", NAMES)
def test_launcher_syntax_and_no_jax_package(name):
    """`bash -n` passes, and the launcher names no module of the JAX
    package, only the port's."""
    path = LAUNCH / name
    subprocess.run(["bash", "-n", str(path)], check=True, timeout=30)
    text = path.read_text()
    assert not re.search(r"qea_ocr_tpu\.", text)
    assert "qea_ocr_tpu_torch." in text and "--device" in text
    assert os.access(path, os.X_OK)


@pytest.mark.parametrize("name", NAMES)
def test_launcher_matches_the_jax_script(name, tmp_path):
    """With every knob at its default, the launcher calls the port's module
    of the JAX script's module with the same flags in the same order (one
    repair, `_repaired`), and `--device cuda`; its flags parse with that
    module's parser."""
    extra = EXTRA.get(name, ["--epoch", "2"])
    env = {"N": "2"} if name == "run_sweep_array.sh" else {}
    port = _record(LAUNCH / name, tmp_path, env, extra)
    jax = _record(SCRIPTS / name, tmp_path, env, extra)
    assert len(port) == len(jax) >= 1
    for p_call, j_call in zip(port, jax):
        assert p_call[0] == j_call[0] == "python"
        p_mod, p_flags = _module_and_flags(p_call)
        j_mod, j_flags = _module_and_flags(j_call)
        assert j_mod.startswith("qea_ocr_tpu.")
        assert p_mod == "qea_ocr_tpu_torch." + j_mod[len("qea_ocr_tpu."):]
        assert importlib.util.find_spec(p_mod) is not None
        assert p_flags[p_flags.index("--device") + 1] == "cuda"
        assert [STAMP.sub("", f) for f in _without_device(p_flags)] == \
            [STAMP.sub("", f) for f in _repaired(name, j_flags)]
        args = _parser(p_mod).parse_args(p_flags)
        assert args.device == "cuda"
        if name in PARALLEL:
            assert not args.data_parallel


@pytest.mark.parametrize("name", PARALLEL)
def test_launcher_runs_torchrun_for_several_gpus(name, tmp_path):
    """NPROC > 1: the same flags through `torchrun --nproc_per_node NPROC`
    with --data_parallel, and the knobs in the environment reach the
    flags."""
    env = dict(NPROC="4", DEVICE="cpu", DATA=str(tmp_path / "d"),
               OCR="Fake")
    (call,) = _record(LAUNCH / name, tmp_path, env, ["--epoch", "2"])
    assert call[:3] == ["torchrun", "--nproc_per_node", "4"]
    module, flags = _module_and_flags(call)
    args = _parser(module).parse_args(flags)
    assert args.data_parallel and args.device == "cpu"
    assert args.ocr == "Fake" and args.epoch == 2
    assert args.data_base_path == str(tmp_path / "d")


def _port_scripts() -> dict:
    with open(ROOT / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return {k: v for k, v in scripts.items()
            if v.startswith("qea_ocr_tpu_torch.")}


@pytest.mark.parametrize("name", sorted(_port_scripts()))
def test_console_script_target_is_callable(name):
    """Each of the port's `[project.scripts]` targets imports and is
    callable; `--help` runs its parser and exits 0."""
    module, func = _port_scripts()[name].split(":")
    main = getattr(importlib.import_module(module), func)
    assert callable(main)
    with pytest.raises(SystemExit) as exit_:
        main(["--help"])
    assert exit_.value.code == 0


def test_every_jax_console_script_has_a_port_twin():
    """`qea-X` of the JAX package has `qea-torch-X` into the same module
    path of the port; export-torch has none (the port's checkpoints are the
    torch schema already), and the port's export is `qea-torch-export-model`.
    """
    with open(ROOT / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port = _port_scripts()
    for name, target in scripts.items():
        if target.startswith("qea_ocr_tpu.") and name != "qea-export-torch":
            twin = "qea-torch-" + name[len("qea-"):]
            assert port[twin] == "qea_ocr_tpu_torch." + \
                target[len("qea_ocr_tpu."):], name
    assert port["qea-torch-export-model"] == \
        "qea_ocr_tpu_torch.tools.export_model:main"
    assert len(port) == 8
