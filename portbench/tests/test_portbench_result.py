"""The result line: its keys, the device entry, the metrics of the cell
in each mode, and the numbers compared last, each with its limit."""

import json

import pytest

from portbench import harness
from portbench.tests import _tiny


@pytest.mark.parametrize("name", ["patch-train-d8", "serve-patch-b32-cmajor"])
def test_result_line(name):
    c = _tiny.cell(name)
    out = _tiny.run(c)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = {m["name"] for m in c.end_to_end}
    assert set(line["metrics"]) == want
    for m in c.end_to_end:
        got = line["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    assert line["correct"] == all(v["value"] <= v["limit"]
                                  for v in line["checks"].values())


def test_traced_line_has_only_per_layer_metrics():
    c = _tiny.cell("patch-train-d8")
    out = _tiny.run(c, trace=True)
    names = {m["name"] for m in c.per_layer}
    assert set(out["metrics"]) <= names
    # on the CPU only the FLOP rate has something to read
    assert set(out["metrics"]) == {"mfu.d8"}


def test_window_and_readers():
    run = harness.Run(_tiny.cell("patch-train-d8"), 1, None)
    run.spans = {"prep_extract": [0.010, 0.030, 0.020]}
    run.kernels = [("void ctc_alpha_kernel<true>(float)", 0.0, 2e-3),
                   ("ctc_beta_grad_kernel", 0.0, 2e-3), ("other", 0, 1.0)]
    run.work = {"ctc_bound_s": 1e-3, "step_flops": 989e12}
    run.untraced = {"seconds": 100.0, "steps": 10, "units": 80}
    run.window_s, run.busy_s = 2.0, 1.5
    read = run.cell.reader
    assert read("prep_extract_ms.d8")(run) == pytest.approx(20.0)
    assert read("ctc_roofline.d8")(run) == pytest.approx(25.0)
    assert read("gather_roofline.d8")(run) is None
    assert read("mfu.d8")(run) == pytest.approx(10.0)
    assert read("idle_share.d8")(run) == pytest.approx(25.0)
