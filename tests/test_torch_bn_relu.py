"""Batch norm + ReLU of the UNet's library route (`ops/bn_relu.py`,
`ops/cuda/bn_relu_cuda.py`, `csrc/bn_relu.cu`).

On the CPU: the plain pair against the float32 chain it replaces
(`models/unet.py:batch_norm` then `F.relu`) in train and eval mode (an
eval-mode norm refuses a backward); the eval-mode operator and its export;
the UNet's library route against the NCHW chain; which routes pass through
the operation and its spans; the CUDA entry points refuse what the kernels
do not take before any launch. The data-group path is `test_torch_dp.py`'s
case `bn_relu`. On a card (marker `chip`; `python -m pytest --noconftest -m
chip tests/test_torch_bn_relu.py` there): the kernels against the plain
pair, and a UNet exported on the card runs them. This file imports no
JAX."""

import copy
import functools

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from qea_ocr_tpu_torch.models import crnn as crnn_mod
from qea_ocr_tpu_torch.models import unet as unet_mod
from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.models.unet import UNet, batch_norm, conv
from qea_ocr_tpu_torch.ops import bn_relu as op
from qea_ocr_tpu_torch.ops.cuda import bn_relu_cuda, build
from qea_ocr_tpu_torch.parallel.multihost import global_numel, global_sum_grad
from qea_ocr_tpu_torch.utils import metrics

# bfloat16 outputs: one rounding of the same float32 value, a unit in the
# last place apart at most where the two float32 chains round differently
BF16_RTOL = 2.0 ** -7
# float32: sums in another order
F32_RTOL = 1e-5

# the operation with the helpers the UNet passes (identities outside a
# data group)
norm = functools.partial(op.bn_relu, group_sum=global_sum_grad,
                         numel=global_numel)


def _bn(C, seed):
    g = torch.Generator().manual_seed(seed)
    bn = nn.BatchNorm2d(C, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
        bn.running_mean.uniform_(-1, 1, generator=g)
        bn.running_var.uniform_(0.5, 2, generator=g)
    return bn


def _pass(fn, bn, y, dz):
    """fn(y, bn) forward and, in train mode, backward on copies: z, dy,
    dweight, dbias and bn's buffers after it."""
    bn = copy.deepcopy(bn)
    yi = y.detach().clone().requires_grad_()
    z = fn(yi, bn)
    if bn.training:
        z.backward(dz)
    return dict(z=z.detach(), dy=yi.grad, dw=bn.weight.grad, db=bn.bias.grad,
                mean=bn.running_mean, var=bn.running_var,
                tracked=bn.num_batches_tracked)


def _refuses_backward(fn, bn, y):
    """An eval-mode `fn(y, bn)` with a gradient asked of it raises."""
    bn = copy.deepcopy(bn)
    z = fn(y.detach().clone().requires_grad_(), bn)
    with pytest.raises(RuntimeError, match="backward"):
        z.sum().backward()


def _close(got, want, rtol, what):
    got, want = got.detach().float(), want.detach().float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rtol * max(scale, 1e-6), (what, err, scale)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("C", [8, 32, 3])
@pytest.mark.parametrize("train", [True, False])
def test_plain_pair_is_the_float32_chain(train, C, layout, dtype):
    """`bn_relu` on CPU tensors against `batch_norm` then `F.relu` (the
    chain the library route ran), on 3x5x7 = 105 rows: the output, the
    running statistics and `num_batches_tracked`, and in train mode dy and
    the weight and bias gradients (eval mode refuses a backward). The two
    differ by float32 rounding, which bfloat16 outputs show as at most one
    unit in the last place."""
    g = torch.Generator().manual_seed(C)
    y = (torch.randn(3, C, 5, 7, generator=g) * 2 + 0.5).to(dtype)
    dz = torch.randn(3, C, 5, 7, generator=g).to(dtype)
    if layout == "channels_last":
        y = y.contiguous(memory_format=torch.channels_last)
        dz = dz.contiguous(memory_format=torch.channels_last)
    bn = _bn(C, C + 1).train(train)
    got = _pass(norm, bn, y, dz)
    want = _pass(lambda t, m: F.relu(batch_norm(m, t)), bn, y, dz)
    rtol = BF16_RTOL if dtype == torch.bfloat16 else F32_RTOL
    assert got["z"].dtype == dtype
    _close(got["z"], want["z"], rtol, "z")
    if train:
        assert got["dy"].dtype == dtype
        # dy is a bfloat16 rounding of a sum of terms that cancel: a unit
        # in the last place of the largest
        _close(got["dy"], want["dy"], 2 * rtol, "dy")
        for k in ("dw", "db"):
            assert got[k].dtype == torch.float32
            _close(got[k], want[k], 1e-4, k)
    else:
        _refuses_backward(norm, bn, y)
    for k in ("mean", "var"):
        _close(got[k], want[k], F32_RTOL, k)
    assert int(got["tracked"]) == int(want["tracked"]) == int(train)
    if not train:
        assert torch.equal(got["mean"], bn.running_mean)
    if layout == "channels_last":
        assert got["z"].is_contiguous(memory_format=torch.channels_last)


def _nchw_forward(m: UNet, x: torch.Tensor) -> torch.Tensor:
    """The library route as it was: NCHW, `batch_norm` then `F.relu`."""
    dt = m.compute_dtype
    enc1 = m.encoder1(x.to(dt), dt)
    enc2 = m.encoder2(F.max_pool2d(enc1, 2), dt)
    dec3 = m._deep_levels(F.max_pool2d(enc2, 2))
    dec2 = m.decoder2(torch.cat([conv(m.upconv2, dec3, dt), enc2], 1), dt)
    dec1 = m.decoder1(torch.cat([conv(m.upconv1, dec2, dt), enc1], 1), dt)
    return torch.sigmoid(conv(m.conv, dec1, dt).float())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_eval_operator_is_the_plain_pair_and_exports(layout, dtype):
    """`qea_ocr::bn_relu_eval` (what an eval-mode norm on CUDA calls) on
    CPU tensors: the eval-mode plain pair bitwise, channels-last; a model
    that calls it exports as one node of it, and the exported program gives
    the same bytes."""
    g = torch.Generator().manual_seed(7)
    y = (torch.randn(3, 8, 5, 7, generator=g) * 2 + 0.5).to(dtype)
    if layout == "channels_last":
        y = y.contiguous(memory_format=torch.channels_last)
    bn = _bn(8, 9).eval()

    class Eval(nn.Module):
        def __init__(self):
            super().__init__()
            self.bn = bn

        def forward(self, t):
            return op.bn_relu_eval_op(t, self.bn.weight, self.bn.bias,
                                      self.bn.running_mean,
                                      self.bn.running_var, self.bn.eps)

    with torch.no_grad():
        want = norm(y, bn)
        got = Eval()(y)
        exported = torch.export.export(Eval(), (y,))
        again = exported.module()(y)
    assert got.dtype == dtype and torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last)
    target = torch.ops.qea_ocr.bn_relu_eval.default
    assert sum(n.op == "call_function" and n.target == target
               for n in exported.graph.nodes) == 1
    assert torch.equal(again, want)


@pytest.mark.parametrize("train", [True, False])
def test_unet_library_route_is_the_nchw_chain(train):
    """A float32 UNet (f=4) on the library route against the NCHW chain it
    replaces, from equal parameters: the output and the running
    statistics, and in train mode every parameter's gradient (an eval-mode
    UNet refuses a backward)."""
    model = UNet(init_features=4, compute_dtype=torch.float32,
                 conv_impl="xla", generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_var.fill_(1.5)
    model.train(train)
    ref = copy.deepcopy(model)
    x = torch.rand(2, 1, 32, 48, generator=torch.Generator().manual_seed(3))
    out = model(x)
    want = _nchw_forward(ref, x)
    _close(out, want, 1e-5, "out")
    w = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
    if train:
        (out * w).sum().backward()
        (want * w).sum().backward()
        ref_params = dict(ref.named_parameters())
        for name, p in model.named_parameters():
            _close(p.grad, ref_params[name].grad, 1e-3, name)
    else:
        with pytest.raises(RuntimeError, match="backward"):
            (out * w).sum().backward()
    ref_buffers = dict(ref.named_buffers())
    for name, b in model.named_buffers():
        _close(b, ref_buffers[name], F32_RTOL, name)


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(a)
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, counted)
    return calls


def test_only_the_library_route_takes_the_operation(monkeypatch):
    """A train forward and backward of the library route passes through
    `bn_relu` 18 times (two a block, nine blocks) and through `batch_norm`
    never, opening `unet.norm` 18 times inside `unet.forward` and
    `unet.norm.backward` 18 times inside `unet.backward`; the CRNN keeps
    `batch_norm`, and the channel-major route's deep levels too (ten
    batch norms below level 2)."""
    norm = _counting(monkeypatch, unet_mod, "bn_relu")
    plain_bn = _counting(monkeypatch, unet_mod, "batch_norm")
    model = UNet(init_features=4, compute_dtype=torch.float32,
                 conv_impl="xla", generator=torch.Generator().manual_seed(0))
    x = torch.rand(2, 1, 32, 32)
    metrics.drain()
    with metrics.recording():
        model(x).sum().backward()
    spans = metrics.drain()
    assert (len(norm), len(plain_bn)) == (18, 0)
    by_id = {s.id: s for s in spans}
    for name, parent in (("unet.norm", "unet.forward"),
                         ("unet.norm.backward", "unet.backward")):
        mine = [s for s in spans if s.name == name]
        assert len(mine) == 18
        assert {by_id[s.parent].name for s in mine} == {parent}

    norm.clear()
    crnn_bn = _counting(monkeypatch, crnn_mod, "batch_norm")
    crnn = CRNN(20, lstm_hidden=8, compute_dtype=torch.float32,
                generator=torch.Generator().manual_seed(1))
    crnn(torch.rand(2, 1, 32, 128)).sum().backward()
    assert (len(norm), len(crnn_bn)) == (0, 2)
    with torch.no_grad():
        model.twin("cmajor").eval()(x)
    assert len(norm) == 0 and len(plain_bn) == 10


def test_cuda_entry_points_refuse_before_any_launch():
    """The kernels' wrapper refuses a CPU tensor, a dtype the kernels lack,
    a tensor that is not 4-D and an empty one; the operation refuses a
    device it has no steps for; nothing launched."""
    counts = (bn_relu_cuda.launches, bn_relu_cuda.bwd_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bn_relu_cuda.rows_view(torch.zeros(2, 8, 3, 3))
    meta = torch.empty(2, 8, 3, 3, device="meta")
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        bn_relu_cuda.rows_view(meta.to(torch.float16))
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        bn_relu_cuda.rows_view(torch.empty(2, 8, device="meta"))
    with pytest.raises(ValueError, match="no rows"):
        bn_relu_cuda.rows_view(torch.empty(0, 8, 3, 3, device="meta"))
    with pytest.raises(ValueError, match="no batch norm"):
        norm(meta, _bn(8, 0))
    assert (bn_relu_cuda.launches, bn_relu_cuda.bwd_launches) == counts


def test_the_kernel_is_built_with_the_others():
    assert "bn_relu" in build.KERNELS
    assert (build.CSRC_DIR / "bn_relu.cu").exists()


@pytest.mark.parametrize("cell,sfx", [("patch-train-d96", "d96"),
                                      ("patch-train-d8", "d8")])
def test_norm_stream_ms_reads_the_norm_spans(cell, sfx):
    """`portbench/metrics/norm_stream_ms.py` on a synthetic traced stretch
    of two steps: the stream time of every `unet.norm` and
    `unet.norm.backward` span over the steps, `prep_extract`'s eval norms
    included; nothing from a program without those spans (the parent's)."""
    from types import SimpleNamespace

    from portbench import harness
    from portbench.tests import _tiny

    def sp(name, parent=None, stream_ms=None):
        return SimpleNamespace(name=name, parent=parent, stream_ms=stream_ms,
                               host_ms=0.0)
    spans = []
    for _ in range(2):
        spans += [sp("prep_extract"), sp("unet.forward", 0, 10.0),
                  sp("unet.norm", 1, 1.0), sp("phase_ab"),
                  sp("unet.forward", 3, 30.0), sp("unet.norm", 4, 2.0),
                  sp("unet.backward", 3, 60.0),
                  sp("unet.norm.backward", 6, 4.0)]
    for with_norms, want in ((True, 7.0), (False, None)):
        run = harness.Run(_tiny.cell(cell), 1, None)
        run.program_spans = [s for s in spans
                             if with_norms or not s.name.startswith(
                                 "unet.norm")]
        got = run.cell.reader(f"norm_stream_ms.{sfx}")(run)
        assert got == (pytest.approx(want) if want else None)


# ------------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", [(3, 32, 5, 7), (2, 3, 9, 11),
                                   (4, 512, 2, 8), (2, 40, 33, 17)])
def test_kernels_are_the_plain_pair(card, shape, train):
    """The kernels against the plain pair on the same bfloat16 operands:
    z and (train) dy within a unit in the last place, the parameters'
    gradients and running statistics within float32 rounding; one launch
    of each forward kernel (two in eval) and three in the backward; an
    eval-mode norm refuses a backward."""
    g = torch.Generator().manual_seed(shape[1])
    y = (torch.randn(*shape, generator=g) * 2 + 0.5).to(torch.bfloat16)
    dz = torch.randn(*shape, generator=g).to(torch.bfloat16)
    bn = _bn(shape[1], 5).train(train)
    want = _pass(norm, bn, y, dz)
    counts = (bn_relu_cuda.launches, bn_relu_cuda.bwd_launches)
    got = _pass(norm, bn.to(card), y.to(card), dz.to(card))
    torch.cuda.synchronize()
    assert (bn_relu_cuda.launches - counts[0],
            bn_relu_cuda.bwd_launches - counts[1]) == ((3, 3) if train
                                                       else (2, 0))
    _close(got["z"].cpu(), want["z"], BF16_RTOL, "z")
    if train:
        _close(got["dy"].cpu(), want["dy"], 2 * BF16_RTOL, "dy")
        for k in ("dw", "db"):
            _close(got[k].cpu(), want[k], 1e-4, k)
    else:
        _refuses_backward(norm, bn.to(card), y.to(card))
    for k in ("mean", "var"):
        _close(got[k].cpu(), want[k], F32_RTOL, k)
    assert int(got["tracked"]) == int(want["tracked"])


@pytest.mark.chip
def test_unet_exported_on_the_card_runs_the_kernels(card, tmp_path):
    """An eval-mode library-route UNet (f=4, bfloat16) exported on the card
    holds 18 `qea_ocr::bn_relu_eval` nodes and no batch norm of ATen's; the
    reloaded artifact launches the kernels (two a norm) and gives the eager
    forward's output."""
    from qea_ocr_tpu_torch.tools.export_model import bn_relu_nodes

    model = UNet(init_features=4, conv_impl="xla",
                 generator=torch.Generator().manual_seed(4)).to(card).eval()
    x = torch.rand(2, 1, 64, 64, generator=torch.Generator().manual_seed(5)
                   ).to(card)
    with torch.no_grad():
        exported = torch.export.export(model, (x,))
        path = tmp_path / "prep.pt2"
        torch.export.save(exported, str(path))
        loaded = torch.export.load(str(path))
        assert bn_relu_nodes(loaded) == 18
        assert not any("batch_norm" in str(n.target)
                       for n in loaded.graph.nodes)
        counts = (bn_relu_cuda.launches, bn_relu_cuda.bwd_launches)
        got = loaded.module()(x)
        torch.cuda.synchronize()
        assert (bn_relu_cuda.launches - counts[0],
                bn_relu_cuda.bwd_launches - counts[1]) == (36, 0)
        # the same operations: a difference is cuDNN choosing another
        # conv algorithm, bfloat16 rounding through a sigmoid
        assert float((got - model(x)).abs().max()) <= 1e-3
