"""Cells, configurations, drivers and metric readers are found by name,
and a new cell with a new metric takes only new files and new entries."""

import json
import shutil

import pytest

from portbench import harness
from portbench.tests import _tiny

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(name):
    c = harness.Cell(BENCH, name)
    assert c.config["unet_features"] == 32
    assert callable(c.driver_class())
    assert c.end_to_end and c.per_layer
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in c.end_to_end}


def test_every_metric_has_a_reader_and_every_config_a_file():
    metrics = harness.HERE / "metrics"
    for m in BENCH["per_layer"]:
        quantity = m["name"].split(".")[0]
        assert (metrics / f"{m['name']}.py").exists() \
            or (metrics / f"{quantity}.py").exists()
    # one reader a quantity, shared by the cells whose entries name it
    assert {p.stem for p in metrics.glob("*.py")} == {
        m["name"].split(".")[0] for m in BENCH["per_layer"]}
    for c in BENCH["configs"]:
        assert (harness.ROOT / c["file"]).exists()
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    t = json.loads((here / "traffic" / "train-d8.json").read_text())
    t["docs"] = 4
    (here / "traffic" / "train-d4.json").write_text(json.dumps(t))
    (here / "metrics" / "untraced_steps.patch.py").write_text(
        "def read(run):\n    return float(run.untraced['steps'])\n")
    bench["workloads"].append({
        "name": "patch-train-d4", "config": bench["workloads"][0]["config"],
        "traffic": "train-d4", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == t["throughput"]:
            m["workloads"].append("patch-train-d4")
    for m in bench["per_layer"]:
        # an existing metric covers the new cell by a new list entry alone
        if m["name"] == "mfu.d8":
            m["workloads"].append("patch-train-d4")
    bench["per_layer"].append({
        "name": "untraced_steps.patch", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "step functions",
        "moves": t["throughput"], "workloads": ["patch-train-d4"]})
    c = _tiny.cell("patch-train-d4", bench, here=here)
    assert c.traffic["docs"] == _tiny.TRAFFIC["docs"]
    out = _tiny.run(c, trace=True)
    assert out["metrics"]["untraced_steps.patch"]["value"] >= 1
    assert out["metrics"]["mfu.d8"]["value"] > 0
    out = _tiny.run(c)
    assert set(out["metrics"]) == {t["throughput"], "setup_s"}
