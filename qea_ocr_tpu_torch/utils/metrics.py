"""Metrics logging (wandb-optional) and profiling helpers (counterpart of
`qea_ocr_tpu/utils/metrics.py`).

The reference's system of record is wandb (`train_nn_patch.py:401-420`);
wandb is not available in every environment, so the logger always writes a
JSONL stream and mirrors to wandb only when importable and enabled.

Also the program's spans, the trainers' step timer built on them, and a
`torch.profiler` trace hook. A span (`span(name)`) marks one layer's call:
its name, its parent, its root (every span of one step function call or one
serving request shares the root's id), its host start and end on the wall
clock that `torch.profiler`'s events use, and on CUDA a pair of timing
events, whose distance is the span's *stream time*: from the stream
reaching the opening event to it reaching the closing one.
`backward_from` / `backward_to`
mark where autograd enters and leaves a model, and give the model's
backward a span of its own.

Spans are off unless a `torch.profiler` session is active or the caller is
inside `recording()`; off, `span` returns a shared null context after one
flag test, and the marks return their tensor untouched. On, a span neither
synchronises nor launches device work (an event record is no kernel, copy
or set), and the spans stay in memory until `drain()`, which the caller
calls after its own sync point. The open spans form one stack for the
process: the autograd engine runs a CUDA backward's marks on its own
thread while the caller waits in `backward()`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


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


class Span:
    """A span of the program: `name`, `id`, `parent` (the enclosing span's
    id, None for a root), `root` (the root's id), host `start_ns` /
    `end_ns` on the wall clock, `stream_ms` (None without CUDA) and `mark`
    (opened by a backward mark)."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns",
                 "stream_ms", "mark", "_start", "_end")

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Recorder:
    """The process's open spans (outermost first) and the closed ones not
    yet drained."""

    def __init__(self):
        self.recording = 0
        self.stack: List[Span] = []
        self.done: List[Span] = []
        self.ids = itertools.count()

    def open(self, name: str, mark: bool = False) -> Optional[Span]:
        stack = self.stack
        if stack and stack[-1].name == name and not mark:
            # a trainer's stage around the step function of that name
            return None
        s = Span()
        parent = stack[-1] if stack else None
        s.name, s.id, s.mark = name, next(self.ids), mark
        s.parent = None if parent is None else parent.id
        s.root = s.id if parent is None else parent.root
        s.stream_ms = s._start = s._end = None
        if torch.cuda.is_initialized():
            s._start = torch.cuda.Event(enable_timing=True)
            s._start.record()
        s.start_ns = time.time_ns()
        stack.append(s)
        return s

    def close(self, s: Optional[Span]) -> None:
        """Close `s` and every span still open inside it, at one time."""
        stack = self.stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is s:
                break
        else:
            return
        end = None
        if torch.cuda.is_initialized():
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        end_ns = time.time_ns()
        for t in stack[i:]:
            t.end_ns, t._end = end_ns, end
        self.done.extend(reversed(stack[i:]))
        del stack[i:]

    def open_mark(self, name: str, nested: bool = False) -> None:
        """A model's backward begins: the previous model's backward, if
        still open, ends here, and this one ends where autograd leaves the
        model or with the backward pass. A `nested` mark (a part of a
        model) opens inside the open one and closes nothing."""
        if not on():
            return
        for t in reversed(self.stack):
            if t.mark and not nested:
                self.close(t)
                break
        s = self.open(name, mark=True)
        torch.autograd.Variable._execution_engine.queue_callback(
            lambda: self.close(s))

    def close_mark(self, name: str) -> None:
        for t in reversed(self.stack):
            if t.mark and t.name == name:
                self.close(t)
                return


_RECORDER = _Recorder()
_NULL = contextlib.nullcontext()


def on() -> bool:
    """Whether spans record: inside `recording()`, or while a
    `torch.profiler` session is active."""
    return bool(_RECORDER.recording
                or _autograd_profiler._is_profiler_enabled)


class _SpanContext:
    __slots__ = ("name", "span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Optional[Span]:
        self.span = _RECORDER.open(self.name)
        return self.span

    def __exit__(self, *exc) -> bool:
        _RECORDER.close(self.span)
        return False


def span(name: str):
    """A span around one layer's call (the module docstring). Inside an
    open span of the same name (a trainer's stage around the step function
    it times) it records nothing more: the outer span is the record."""
    if not (_RECORDER.recording or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _SpanContext(name)


def backward_from(t: torch.Tensor, name: str,
                  nested: bool = False) -> torch.Tensor:
    """Mark a model's output: where autograd reaches it, the span `name`
    (the model's backward) opens. A hook on the tensor, registered only
    while spans record and `t` takes a gradient: the graph is the same
    either way, and the hook passes the gradient on untouched. `nested`
    marks the output of a part of a model, whose backward span opens
    inside the model's (its input's `backward_to` closes it)."""
    if t.requires_grad and on():
        t.register_hook(lambda g: _RECORDER.open_mark(name, nested))
    return t


def backward_to(t: torch.Tensor, name: str) -> torch.Tensor:
    """Mark a model's input: where autograd has its gradient, the span
    `name` closes. An input that takes no gradient leaves the span to
    close with the backward pass (or where the next model's opens)."""
    if t.requires_grad and on():
        t.register_hook(lambda g: _RECORDER.close_mark(name))
    return t


@contextlib.contextmanager
def recording():
    """Spans record inside, without a profiler session."""
    _RECORDER.recording += 1
    try:
        yield
    finally:
        _RECORDER.recording -= 1


def drain() -> List[Span]:
    """The closed spans since the last drain, in the order they opened,
    their stream times resolved. Call after the work's sync point (it
    waits for each closing event)."""
    done, _RECORDER.done = _RECORDER.done, []
    for s in done:
        if s._start is not None and s._end is not None:
            s._end.synchronize()
            s.stream_ms = s._start.elapsed_time(s._end)
        s._start = s._end = None
    done.sort(key=lambda s: s.id)
    return done


class StepTimer:
    """Host-clock totals of a trainer's stages (`time/<stage>_mean_s`,
    `time/<stage>_total_s`), on a monotonic clock. Each stage is also a
    span: with spans on (a profiler session, `recording()`), its record
    carries the stage's stream time too. On a CUDA device a stage's host
    time is that of enqueueing it unless the stage ends in a host read."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
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


def _trace_events(spans: List[Span], base_ns: int) -> list:
    """Chrome-trace complete events of `spans` (microseconds after
    `base_ns`), on a track of their own."""
    return [{"ph": "X", "cat": "program_span", "name": s.name,
             "pid": "Program spans", "tid": 0,
             "ts": (s.start_ns - base_ns) / 1e3, "dur": s.host_ms * 1e3,
             "args": {"id": s.id, "parent": s.parent, "root": s.root,
                      "stream_ms": s.stream_ms}}
            for s in spans]


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """A `torch.profiler` trace (CPU, and CUDA when there is a card) written
    as `trace.json` under the directory when one is given, with the
    program's spans of the session merged in on the profiler's clock; a
    no-op otherwise."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    spans = drain()
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(_trace_events(
        spans, int(trace.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(trace, f)
