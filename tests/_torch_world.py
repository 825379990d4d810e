"""Spawns a CPU (Gloo) world of `_torch_dp_worker.py` processes and reads
back what each rank wrote: the fixture of the port's multi-process tests."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("_torch_dp_worker.py")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_world(mode: str, world: int, out_dir: Path,
              timeout: float = 240.0) -> list:
    """Run `mode` on `world` ranks; returns each rank's results, in rank
    order. A rank that fails, or a world that hangs past `timeout`
    seconds, fails the caller with the ranks' output."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               QEA_TEST_TIMEOUT=str(int(timeout) - 10))
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), mode, str(r), str(world), str(port),
         str(out_dir)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "WORKER_OK" in out, \
            f"rank {r} of {mode}:\n{out[-4000:]}"
    return [json.loads((out_dir / f"{mode}_{r}.json").read_text())
            for r in range(world)]


def case(results: list, name: str) -> list:
    """The readings of case `name` on every rank; fails with its error
    where one rank raised."""
    for r, res in enumerate(results):
        assert "error" not in res[name], f"rank {r}:\n{res[name]['error']}"
    return [res[name] for res in results]
