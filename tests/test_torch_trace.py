"""The port's spans (`utils/metrics.py`): off by default and then without
effect on the autograd graph or the numbers, their nesting through the
patch step and its backward, their clock against `torch.profiler`'s, and
the serving request's stages. Tiny models on the CPU."""

import contextlib
import copy
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.serve.cleaner import DocumentCleaner
from qea_ocr_tpu_torch.tools.bench_batch import bench_batch, phase_ab
from qea_ocr_tpu_torch.train.patch_steps import make_steps
from qea_ocr_tpu_torch.train.state import adam_l2
from qea_ocr_tpu_torch.utils import metrics
from qea_ocr_tpu_torch.utils.charmap import CharMap

# tiny shapes: intra-op threads gain nothing, as in the parity tests
torch.set_num_threads(1)
DOC = (48, 144)


@pytest.fixture(autouse=True)
def no_leftover_spans():
    metrics.drain()
    yield
    metrics.drain()


def _models():
    cm = CharMap.default()
    unet = UNet(init_features=4, compute_dtype=torch.float32,
                generator=torch.Generator().manual_seed(0))
    crnn = CRNN(cm.vocab_size, lstm_hidden=8, compute_dtype=torch.float32,
                generator=torch.Generator().manual_seed(1))
    return cm, unet, crnn


def _step(cm, unet, crnn, timer=None):
    """prep_extract then one phase_ab on a document of 2 strip slots
    (inside `timer`'s stage `phase_ab` if given, as the trainer times it);
    returns every output and the updated parameters."""
    steps = make_steps(unet, crnn, cm,
                       prep_optimizer=adam_l2(unet.parameters(), 1e-3, 0.0),
                       crnn_optimizer=adam_l2(crnn.parameters(), 1e-3, 0.0))
    b = bench_batch(cm, 1, 2, torch.device("cpu"), doc_size=DOC)
    _, strips = steps.prep_extract(b["images"], b["bboxes"])
    jitter = (strips + 0.1 * torch.randn(
        strips.shape, generator=torch.Generator().manual_seed(2)))[None]
    with timer.time("phase_ab") if timer else contextlib.nullcontext():
        doc_out, m, cer, ent, loss_a = phase_ab(steps, b, strips, jitter)
    return [strips, doc_out, m["loss"], m["cers"], m["decoded"], cer, ent,
            loss_a, *unet.parameters(), *crnn.parameters()]


def _graph(t):
    """Node names of the autograd graph under `t`, depth first."""
    seen, out, todo = set(), [], [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        out.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return out


def _profiled_step(spans_on: bool):
    """`_step` on fresh models under a CPU profiler, with the spans on or
    switched off (the flag `span` reads made False): (outputs, the
    operators' names and counts, the spans)."""
    cm, unet, crnn = _models()
    with pytest.MonkeyPatch.context() as mp:
        if not spans_on:
            class Off:
                _is_profiler_enabled = False
            mp.setattr(metrics, "_autograd_profiler", Off)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = _step(cm, unet, crnn)
        spans = metrics.drain()
    ops = {}
    for e in prof.profiler.kineto_results.events():
        ops[e.name()] = ops.get(e.name(), 0) + 1
    return out, ops, spans


def test_off_records_nothing_and_changes_nothing():
    assert not metrics.on()
    assert metrics.span("a") is metrics.span("b")      # the shared null
    _, unet, _ = _models()
    twin = copy.deepcopy(unet)
    x = torch.rand(2, 1, *DOC)

    off = unet(x)
    assert not off._backward_hooks
    assert metrics.drain() == []
    with metrics.recording():
        on = twin(x)
    assert on._backward_hooks                          # the mark is a hook
    assert [s.name for s in metrics.drain()] == ["unet.forward"]
    assert _graph(off) == _graph(on)
    assert torch.equal(off, on)

    # the whole step: the same numbers and the same operators, no
    # operation added by a span or a mark
    plain, plain_ops, none = _profiled_step(False)
    assert none == []
    traced, traced_ops, spans = _profiled_step(True)
    assert spans
    assert traced_ops == plain_ops
    for a, b in zip(plain, traced, strict=True):
        assert torch.equal(a, b)


def _tree(spans):
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    return kids


def test_spans_nest_through_the_step_and_its_backward():
    cm, unet, crnn = _models()
    timer = metrics.StepTimer()
    with metrics.recording():
        _step(cm, unet, crnn, timer)        # a stage and its step function
    spans = metrics.drain()
    kids = _tree(spans)
    names = lambda ss: [s.name for s in ss]             # noqa: E731
    roots = kids[None]
    assert names(roots) == ["prep_extract", "phase_ab"]
    prep, ab = roots
    assert names(kids[prep.id]) == ["unet.forward", "gather"]
    assert names(kids[ab.id]) == ["phase_a", "phase_b"]
    a, b = kids[ab.id]
    assert names(kids[a.id]) == ["crnn.forward", "loss", "backward",
                                 "optimizer"]
    assert names(kids[b.id]) == ["unet.forward", "gather", "crnn.forward",
                                 "loss", "backward", "optimizer", "tables"]
    back_a = kids[a.id][2]
    assert names(kids[back_a.id]) == ["crnn.backward"]
    back_b = kids[b.id][4]
    assert names(kids[back_b.id]) == ["crnn.backward", "gather.backward",
                                      "unet.backward"]
    loss_b = kids[b.id][3]
    assert names(kids[loss_b.id]) == ["ctc"]
    by_id = {s.id: s for s in spans}
    for s in spans:
        root = s
        while root.parent is not None:
            root = by_id[root.parent]
        assert s.root == root.id
        assert s.start_ns <= s.end_ns and s.stream_ms is None
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        inner = kids.get(s.id, [])
        assert s.host_ms - sum(k.host_ms for k in inner) >= 0
        for k0, k1 in zip(inner, inner[1:]):
            assert k0.end_ns <= k1.start_ns
    assert timer.counts == {"phase_ab": 1}


def test_a_profiler_session_turns_spans_on_on_its_clock():
    _, unet, _ = _models()
    x = torch.rand(2, 1, *DOC)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert metrics.on()
        unet(x)
    assert not metrics.on()
    (s,) = metrics.drain()
    assert s.name == "unet.forward"
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::sigmoid"]
    assert ops
    for e in ops:
        assert s.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s.end_ns


def test_clean_request_has_its_six_stages():
    sd = UNet(init_features=4).state_dict()
    cleaner = DocumentCleaner(state_dict=sd, device="cpu", batch_size=2,
                              doc_size=(32, 64), unet_features=4)
    rng = np.random.default_rng(0)
    docs = [rng.random(hw, dtype=np.float32)
            for hw in ((20, 30), (32, 64), (10, 50))]
    with metrics.recording():
        out = cleaner.clean_arrays_uint8(docs)
    assert [o.shape for o in out] == [(20, 30), (32, 64), (10, 50)]
    spans = metrics.drain()
    kids = _tree(spans)
    (clean,) = kids[None]
    assert clean.name == "clean"
    stages = ["fit", "upload", "quantise", "unet.forward", "download",
              "crop"]
    assert [s.name for s in kids[clean.id]] == stages * 2   # two batches
    assert all(s.root == clean.id for s in spans)


def test_maybe_profile_merges_the_spans(tmp_path):
    _, unet, _ = _models()
    with metrics.maybe_profile(str(tmp_path)):
        unet(torch.rand(1, 1, *DOC))
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in mine] == ["unet.forward"]
    sig = [e for e in events if e.get("name") == "aten::sigmoid"]
    assert sig and mine[0]["ts"] <= sig[0]["ts"]
    assert sig[0]["ts"] + sig[0]["dur"] <= mine[0]["ts"] + mine[0]["dur"]
    assert metrics.drain() == []
