"""The four-card cell's driver (`portbench/drivers/train_patch_dp4.py`) in
lock-step at a world of 4 over Gloo on the CPU, at a tiny size: rank 0 is
a process of its own (as the harness's is), starts ranks 1-3, steps them
through the timed window and stops them, and every rank's comparison with
the reference of the global step comes out correct, and an exchange
between the ranks left out in set-up (`portbench/faults_dp4.py`) parts the
replicas. A world that hangs fails the test at its own time limit."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RANK0 = """
import json, os, time, torch
from portbench import faults_dp4, harness
from portbench.tests import _tiny
torch.set_num_threads(1)
fault = os.environ.get("PORTBENCH_DP_FAULT") or None
load = harness.Cell.driver_class
def planted(self):
    class Driver(load(self)):
        def setup(self):
            with faults_dp4.planted(fault):
                super().setup()
    return Driver
harness.Cell.driver_class = planted
c = _tiny.cell("patch-train-d96-dp4")
c.traffic.update(checked_steps=1, warmup_steps=0, start_timeout_s=60,
                 wait_timeout_s=60)
out = harness.run_cell(c, 2 ** 31 + 11, 0.3, False, torch.device("cpu"),
                       time.perf_counter(), log=lambda m: None)
print(json.dumps(out))
"""


def _rank0(fault: str = "") -> dict:
    """The tiny cell's result line, `fault` planted in every rank."""
    done = subprocess.run([sys.executable, "-c", RANK0], cwd=ROOT,
                          capture_output=True, text=True, timeout=150,
                          env=dict(os.environ, OMP_NUM_THREADS="1",
                                   PORTBENCH_DP_FAULT=fault))
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_four_ranks_step_in_lock_step_and_agree():
    out = _rank0()
    assert out["correct"] is True, out["checks"]
    assert out["device"]["count"] == 4
    assert out["steps"]["n"] >= 1
    assert out["metrics"]["train_docs_per_s"]["value"] > 0
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["selection_diff"] == 0 and checks["table_gap"] == 0
    assert checks["loss_gap"] < 1e-3
    assert checks["replica_gap"] == 0


def test_local_batch_statistics_part_the_replicas():
    out = _rank0("local batch statistics")
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert out["correct"] is False
    assert checks["replica_gap"] > 0
