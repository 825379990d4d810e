"""The benchmark's own tests. They run on the CPU at tiny sizes:

    python -m pytest portbench/tests -q

A test that needs a CUDA card carries the `chip` marker and decides
inside itself whether there is one (on the card: `-m chip`)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")
