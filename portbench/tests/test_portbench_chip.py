"""On a CUDA card: one short run of the smallest training cell through
the command, its last line parsed. Skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench import harness


@pytest.mark.chip
def test_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "patch-train-d8", "--seed", str(2 ** 31 + 3), "--seconds", "2",
         "--trace", "0"], cwd=str(harness.ROOT), capture_output=True,
        text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["train_docs_per_s"]["value"] > 0
