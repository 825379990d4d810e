"""What the per-layer metric readers share. Each reader is a file of its
own in `metrics/`, `read(run) -> float | None`; None leaves the metric out
of the result line (nothing to read in this run)."""

from __future__ import annotations

import statistics

from portbench import counts


def span_ms(run, name: str):
    """The median over the traced stretch of a span's host time, ms."""
    s = run.spans.get(name)
    return 1e3 * statistics.median(s) if s else None


def roofline(run, kernels: tuple, bound_key: str):
    """Sum of the least times of the kernels' work in the traced steps over
    the device time of the kernels whose names hold one of `kernels`, %."""
    dev = sum(d for n, _, d in run.kernels if any(k in n for k in kernels))
    bound = run.work.get(bound_key)
    if not dev or not bound:
        return None
    return 100.0 * bound / dev


def mfu(run):
    """Model FLOPs of the steps of the untraced part of a traced run over
    their host time, against the bfloat16 peak, %."""
    u = run.untraced
    fl = run.work.get("step_flops")
    if not u or not fl or not u["seconds"]:
        return None
    return 100.0 * fl * u["steps"] / u["seconds"] / counts.PEAK_BF16


def idle_share(run):
    """Share of the traced stretch in which no operation ran on the
    device, %."""
    if not run.window_s or run.busy_s is None:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
