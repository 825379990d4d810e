"""Metrics logging (wandb-optional) and profiling helpers (counterpart of
`qea_ocr_tpu/utils/metrics.py`).

The reference's system of record is wandb (`train_nn_patch.py:401-420`);
wandb is not available in every environment, so the logger always writes a
JSONL stream and mirrors to wandb only when importable and enabled. Also the
step timer and a `torch.profiler` trace hook.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, use_wandb: bool = False,
                 wandb_config: Optional[dict] = None):
        self.log_path = os.path.join(log_dir, "metrics.jsonl") if log_dir else None
        if self.log_path:
            os.makedirs(log_dir, exist_ok=True)
        self._wandb = None
        self.summary: Dict[str, Any] = {}
        if use_wandb:
            try:
                import wandb
                wandb.init(**(wandb_config or {}))
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict[str, Any]) -> None:
        record = {k: _to_py(v) for k, v in metrics.items()}
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(record)

    def update_summary(self, metrics: Dict[str, Any]) -> None:
        self.summary.update({k: _to_py(v) for k, v in metrics.items()})
        if self._wandb is not None:
            self._wandb.run.summary.update(metrics)

    def save_file(self, path: str) -> None:
        if self._wandb is not None:
            self._wandb.save(path)


def _to_py(v):
    """numpy scalars and 0-d arrays or tensors -> plain Python numbers."""
    if hasattr(v, "item") and getattr(v, "shape", None) in ((), None):
        return v.item()
    return v


class StepTimer:
    """Wall-clock accounting per phase (device step vs host OCR). On a CUDA
    device a phase's time is that of enqueueing it unless the phase ends in a
    host read."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {
            f"time/{k}_mean_s": self.totals[k] / max(1, self.counts[k])
            for k in self.totals
        } | {f"time/{k}_total_s": v for k, v in self.totals.items()}


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """A `torch.profiler` trace (CPU, and CUDA when there is a card) written
    as `trace.json` under the directory when one is given; a no-op
    otherwise."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
