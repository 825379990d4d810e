"""The program's own spans of a traced run (`utils/metrics.py` of the
port: `span`, `drain`), drained once and kept on the run for every reader.

The traced stretch's `torch.profiler` session is what turns the program's
spans on, so what is drained is that stretch's. A program whose `metrics`
has no `drain` gives no spans, and each reader then leaves its metric out."""

from __future__ import annotations

STEP_ROOTS = ("phase_ab", "phase_b")


def spans(run) -> list:
    cached = getattr(run, "program_spans", None)
    if cached is None:
        from qea_ocr_tpu_torch.utils import metrics
        drain = getattr(metrics, "drain", None)
        cached = list(drain()) if drain is not None else []
        run.program_spans = cached
    return cached


def steps(run) -> int:
    """The training steps of the stretch: its root `phase_ab` (patch) or
    `phase_b` (area) spans."""
    return sum(1 for s in spans(run)
               if s.parent is None and s.name in STEP_ROOTS)


def roots(run, name: str) -> int:
    return sum(1 for s in spans(run) if s.parent is None and s.name == name)


def stream_ms_per_step(run, names: tuple):
    """The stream time of every span named in `names`, over the stretch's
    training steps, ms."""
    n = steps(run)
    times = [s.stream_ms for s in spans(run) if s.name in names]
    if not n or not times or any(t is None for t in times):
        return None
    return sum(times) / n


def host_ms_per_root(run, names: tuple, root: str):
    """The host time of every span named in `names`, over the stretch's
    root spans named `root`, ms."""
    n = roots(run, root)
    times = [s.host_ms for s in spans(run) if s.name in names]
    if not n or not times:
        return None
    return sum(times) / n
