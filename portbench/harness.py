"""One run of one cell: set-up, the measured window, the traced stretch, the
comparison with the plain reference, and the result line.

Everything that belongs to one cell is found by name: the cell in
`BENCHMARK.json`, its configuration (the file the entry names), its
traffic (`portbench/traffic/<traffic>.json`), its driver
(`portbench/drivers/<driver>.py`, named by the traffic), its limits
(`portbench/limits/<cell>.json`) and each per-layer metric's reader
(`portbench/metrics/<metric>.py`, or the quantity's reader, named by the
metric's name before its first dot). Adding a cell, a configuration or a
metric adds files and entries; no file here changes.

A driver is a class `Driver(run)` with `unit` and the methods `setup()`
(build the program's objects from the seed, drive the first steps that
the comparison follows, warm the cell's shapes), `step(i)` (one timed step
or request; returns the units it completed), `end_to_end(rec)`,
`work(profiled)` (what the metric readers need from the steps that were
profiled), `release()` (free the program's state) and `check()`
(`[(name, value, limit)]`, value <= limit passes).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qea_ocr_tpu")
CACHE = ROOT / ".portbench_cache"


def set_environment(env: dict) -> None:
    """Caches inside the checkout at fixed paths, JAX kept out of any
    library that would load it, and the cell's own variables."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for k, v in env.items():
        os.environ[k] = str(v)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A file of the benchmark as a module, by its path (names may hold
    dots)."""
    name = "portbench_" + "".join(c if c.isalnum() else "_"
                                  for c in f"{path.parent.name}/{path.name}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of `BENCHMARK.json` with everything found by its names."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT,
                 here: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.here = here
        self.traffic = load_json(here / "traffic"
                                 / f"{self.entry['traffic']}.json")
        limits = here / "limits" / f"{name}.json"
        self.limits = load_json(limits) if limits.exists() else {}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m["workloads"]] + [
            m for m in bench["per_layer"]
            if "workloads" not in m and m["moves"] in moved]

    def driver_class(self):
        return load_module(self.here / "drivers"
                           / f"{self.traffic['driver']}.py").Driver

    def reader(self, metric: str):
        """`metrics/<metric>.py`, or else the reader of the quantity, the
        name before its first dot (`mfu.d8` -> `metrics/mfu.py`): one
        reader serves every cell whose entry names it."""
        path = self.here / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.here / "metrics" / f"{metric.split('.')[0]}.py"
        return load_module(path).read


class Run:
    """What a driver and the metric readers share: the cell, the seed and
    device, the spans of the traced stretch, and its profile."""

    def __init__(self, cell: Cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.traffic = cell.config, cell.traffic
        self.tracing = False           # spans on: the profiled stretch
        self.spans: dict[str, list[float]] = {}
        self.span_times: list[tuple[str, float, float]] = []
        self.kernels: list[tuple[str, float, float]] = []
        self.window_s = None
        self.busy_s = None
        self.untraced = None
        self.work = {}
        self.gaps = []

    @contextmanager
    def span(self, name: str):
        """A span around a call into a layer: off (no cost) outside the
        traced stretch; inside it closed by a synchronise, its host time
        kept, and its interval on the wall clock (the profiler's time
        base) kept to label the device's idle gaps."""
        if not self.tracing:
            yield
            return
        import torch
        t0, w0 = time.perf_counter(), time.time_ns()
        yield
        torch.cuda.synchronize()
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)
        self.span_times.append((name, w0 / 1e9, time.time_ns() / 1e9))


def forbidden_loaded() -> list[str]:
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _window(driver, seconds: float, first: int = 0):
    """Steps until `seconds` have passed; the rate's window ends with the
    last step."""
    lat, units, i = [], 0, first
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        units += driver.step(i)
        b = time.perf_counter()
        lat.append(b - a)
        i += 1
        if b - t0 >= seconds:
            break
    return dict(units=units, elapsed=b - t0, latencies=lat, steps=len(lat),
                next=i)


def _profile(run: Run, driver, steps: int, first: int):
    """`steps` steps under the profiler (device activity only: recording
    every host operation would double a launch-bound step's host time)
    with the spans on. The window is the stretch's host time; busy time
    the union of the device's kernels and copies in it; each idle gap is
    labelled by the span the host was in at its middle."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    run.tracing = True
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + steps):
            driver.step(i)
        torch.cuda.synchronize()
        run.window_s = time.perf_counter() - t0
    run.tracing = False
    dev = [(e.name(), e.start_ns() / 1e9, e.duration_ns() / 1e9)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    if not dev:
        return
    run.kernels = dev
    ivals = sorted((s, s + d) for _, s, d in dev)
    busy, cur_s, cur_e, gaps = 0.0, None, None, []
    for s, e in ivals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    run.busy_s = busy

    def label(mid):
        inside = [n for n, s, e in run.span_times if s <= mid <= e]
        return inside[0] if inside else "between spans"
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    run.gaps = [[label((a + b) / 2), b - a] for a, b in gaps[:10]]


def breakdown(run: Run) -> dict:
    total: dict[str, float] = {}
    for name, _, dur in run.kernels:
        total[name[:120]] = total.get(name[:120], 0.0) + dur
    ops = sorted(total.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": run.gaps}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=None) -> dict | None:
    """One run; returns the result object, or None where the process must
    exit without one (a forbidden module was loaded by the end)."""
    import torch
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    on_gpu = device.type == "cuda"
    if on_gpu:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    run = Run(cell, seed, device)
    driver = cell.driver_class()(run)
    log(f"[portbench] process start to the driver's set-up "
        f"{time.perf_counter() - t_start:.3f} s")
    driver.setup()
    if on_gpu:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"[portbench] {cell.name} seed {seed}: set-up {setup_s:.3f} s")

    if not trace:
        rec = _window(driver, seconds)
        profiled = 0
    else:
        rec = _window(driver, seconds * 0.7)
        run.untraced = dict(seconds=rec["elapsed"], steps=rec["steps"],
                            units=rec["units"])
        profiled = int(cell.traffic["profile_steps"]) if on_gpu else 0
        if profiled:
            _profile(run, driver, profiled, rec["next"])
    if on_gpu:
        torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated(device)) if on_gpu else 0
    run.work = driver.work(profiled)
    e2e = driver.end_to_end(rec)
    driver.release()
    if on_gpu:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = driver.check()
    log(f"[portbench] reference comparison {time.perf_counter() - t_ref:.3f} s")

    metrics = {}
    if not trace:
        values = dict(e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = cell.reader(m["name"])(run)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = all(v <= lim for _, v, lim in checks)
    out = {"correct": correct, "attempted": rec["steps"] + profiled,
           "failed": 0, "metrics": metrics,
           "device": {"platform": "gpu" if on_gpu else device.type,
                      "kind": (torch.cuda.get_device_name(device)
                               if on_gpu else "cpu"),
                      "count": int(cell.entry.get("chips", 1)),
                      "memory_peak_bytes": peak}}
    if trace and run.busy_s is not None:
        out["device"]["busy_s"] = run.busy_s
        out["device"]["window_s"] = run.window_s
        out["breakdown"] = breakdown(run)
    lat = sorted(rec["latencies"])
    out["steps"] = {"n": len(lat), "median_s": lat[len(lat) // 2],
                    "p10_s": lat[len(lat) // 10],
                    "p90_s": lat[(9 * len(lat)) // 10]}
    out["card"] = card_line() if on_gpu else "cpu"
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    # last, after the comparison and the readers, which load modules too
    found = forbidden_loaded()
    if found:
        log(f"[portbench] loaded after the window: {', '.join(found)}")
        return None
    return out


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="one run of one cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = Cell(bench, args.workload)
    set_environment({**cell.config.get("env", {}),
                     **cell.traffic.get("env", {})})
    import torch
    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[portbench] needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    if out is None:
        return 4
    for name, c in out["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
