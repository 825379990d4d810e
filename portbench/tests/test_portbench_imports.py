"""Nothing the benchmark runs loads JAX or the JAX package; the check
compares whole top-level names; the reference loads nothing of the
program; without a card the command exits non-zero with no result."""

import json
import shutil
import subprocess
import sys

from portbench import harness

ROOT = str(harness.ROOT)


def test_whole_name_check(monkeypatch):
    monkeypatch.setitem(sys.modules, "qea_ocr_tpu_torch_fake", object())
    assert "qea_ocr_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "qea_ocr_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_loaded() == ["jax", "qea_ocr_tpu"]


def _loaded_by(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded_by("import portbench.reference.train, "
                     "portbench.reference.serve, portbench.compare, "
                     "portbench.counts, portbench.traffic")
    assert not top & {"qea_ocr_tpu_torch", "qea_ocr_tpu", "jax", "flax"}


def test_a_run_loads_no_jax():
    top = _loaded_by(
        "from portbench.tests import _tiny\n"
        "out = _tiny.run(_tiny.cell('patch-train-d8'))\n"
        "assert out is not None")
    assert "qea_ocr_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "patch-train-d8", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path):
    """The check runs last: a metric reader, which runs after the window
    and the comparison, that loads JAX leaves the run without a result."""
    here = tmp_path / "portbench"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (here / "metrics" / "leak.py").write_text(
        "def read(run):\n    import jax  # noqa: F401\n    return 1.0\n")
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "leak.d8", "unit": "x", "better": "lower",
        "source": "program_counter", "layer": "device",
        "moves": "train_docs_per_s.d8", "workloads": ["patch-train-d8"]})
    (tmp_path / "bench.json").write_text(json.dumps(bench))
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        "from portbench.tests import _tiny\n"
        f"bench = json.loads(Path({str(tmp_path / 'bench.json')!r})"
        ".read_text())\n"
        f"c = _tiny.cell('patch-train-d8', bench, here=Path({str(here)!r}))\n"
        "out = _tiny.run(c, trace=True)\n"
        "print(json.dumps([out is None, 'jax' in sys.modules]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, check=True)
    assert json.loads(p.stdout.strip().splitlines()[-1]) == [True, True]
