"""The readers of the program's own spans, on a synthetic run: each
model's stream time over the training steps, the serving request's
preparation, device operations a step, and nothing read from a program
that has no spans."""

from types import SimpleNamespace

import pytest

from portbench import harness, program_spans
from portbench.tests import _tiny


def _span(name, parent=None, stream_ms=None, host_ms=0.0):
    return SimpleNamespace(name=name, parent=parent, stream_ms=stream_ms,
                           host_ms=host_ms)


def _run(cell, spans, kernels=()):
    run = harness.Run(_tiny.cell(cell), 1, None)
    run.program_spans = spans
    run.kernels = list(kernels)
    return run


@pytest.mark.parametrize("cell,root,sfx", [
    ("patch-train-d96", "phase_ab", "d96"),
    ("patch-train-d8", "phase_ab", "d8"),
    ("area-train-b64", "phase_b", "area")])
def test_model_stream_time_and_launches_a_step(cell, root, sfx):
    spans = []
    for step in range(2):
        spans += [_span("prep_extract"), _span("unet.forward", 0, 10.0),
                  _span(root), _span("phase_b", 2),
                  _span("unet.forward", 3, 30.0),
                  _span("crnn.forward", 3, 5.0),
                  _span("crnn.backward", 4, 7.0),
                  _span("unet.backward", 4, 60.0)]
    run = _run(cell, spans, kernels=[("k", 0.0, 1e-3)] * 900)
    read = run.cell.reader
    assert read(f"unet_stream_ms.{sfx}")(run) == pytest.approx(100.0)
    assert read(f"crnn_stream_ms.{sfx}")(run) == pytest.approx(12.0)
    if sfx != "d96":
        assert read(f"launches.{sfx}")(run) == pytest.approx(450.0)


def test_clean_prepare_a_request():
    spans = []
    for _ in range(4):
        spans += [_span("clean", host_ms=100.0),
                  _span("fit", 0, host_ms=30.0),
                  _span("quantise", 0, host_ms=20.0),
                  _span("upload", 0, host_ms=5.0),
                  _span("unet.forward", 0, 22.0, host_ms=1.0),
                  _span("download", 0, host_ms=25.0),
                  _span("crop", 0, host_ms=0.1)]
    run = _run("serve-patch-b32-cmajor", spans)
    assert run.cell.reader("clean_prepare_ms.serve")(run) \
        == pytest.approx(55.0)


def test_nothing_to_read():
    # on the CPU: spans without stream times, no device events
    run = _run("patch-train-d8", [_span("phase_ab"),
                                  _span("unet.forward", 0, None)])
    assert run.cell.reader("unet_stream_ms.d8")(run) is None
    assert run.cell.reader("launches.d8")(run) is None
    # no training step in the stretch
    run = _run("patch-train-d8", [_span("unet.forward", None, 3.0)],
               kernels=[("k", 0.0, 1.0)])
    assert run.cell.reader("unet_stream_ms.d8")(run) is None
    assert run.cell.reader("launches.d8")(run) is None
    run = _run("serve-patch-b32-cmajor", [])
    assert run.cell.reader("clean_prepare_ms.serve")(run) is None


def test_a_program_without_spans_gives_none(monkeypatch):
    from qea_ocr_tpu_torch.utils import metrics
    monkeypatch.delattr(metrics, "drain")
    run = harness.Run(_tiny.cell("patch-train-d8"), 1, None)
    run.kernels = [("k", 0.0, 1.0)]
    assert program_spans.spans(run) == []
    assert run.cell.reader("launches.d8")(run) is None
    assert run.cell.reader("crnn_stream_ms.d8")(run) is None


def test_spans_are_drained_once_a_run():
    from qea_ocr_tpu_torch.utils import metrics
    metrics.drain()
    with metrics.recording(), metrics.span("phase_ab"):
        pass
    run = harness.Run(_tiny.cell("patch-train-d8"), 1, None)
    first = program_spans.spans(run)
    assert [s.name for s in first] == ["phase_ab"]
    assert program_spans.spans(run) is first
    assert program_spans.steps(run) == 1
