"""The port's channel-major 3x3 conv (`ops/conv_cmajor.py`, the plain version
on CPU tensors) against the JAX package's Pallas kernel in interpret mode:
the same numpy inputs through both.

Tolerance: relative L2 under 6e-3, the JAX package's own bound in
`tests/test_conv_cmajor.py` (bfloat16 rounding of the output, eps 3.9e-3).
Both sides multiply the same bfloat16-quantised operands and accumulate in
float32, so what is observed is far below it: 1e-6 to 3e-5 forward (a few
outputs land on the other side of a bfloat16 rounding boundary), 0 to 2e-3
on the gradients (dX is rounded to bfloat16 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qea_ocr_tpu.ops.pallas import conv_cmajor as jcc
from qea_ocr_tpu_torch.ops import conv_cmajor as tcc
from qea_ocr_tpu_torch.ops.cuda import conv_cmajor_cuda

import _torch_parity  # noqa: F401  (one torch thread)

D, CIN, COUT, W = 2, 6, 5, 128
REL_L2 = 6e-3


def _bf16(a):
    """float32 numpy -> the same values rounded to bfloat16, as float32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _operands(seed, h):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((D, CIN, h, W)).astype(np.float32))
    w = _bf16((0.1 * rng.standard_normal((3, 3, CIN, COUT))).astype(np.float32))
    return x, w


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _garbage_halos(xf, h):
    xf = np.array(xf, np.float32)
    xf[:, :, :W] = 1e4
    xf[:, :, (h + 1) * W:] = -1e4
    return xf


@pytest.fixture(scope="module", params=[8, 24])   # 1 and 3 TPU tiles
def case(request):
    """Everything the JAX side computes for one height, once."""
    h = request.param
    x, w = _operands(h, h)
    rng = np.random.default_rng(100 + h)
    mul = (0.5 + rng.random(COUT)).astype(np.float32)
    add = rng.standard_normal(COUT).astype(np.float32)
    g = rng.standard_normal((D, COUT, h, W)).astype(np.float32)
    jx, jw = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16)
    jxf = jcc.pad_flat(jx)
    out = dict(h=h, x=x, w=w, mul=mul, add=add, g=g)
    out["xf"] = np.asarray(jxf.astype(jnp.float32))
    out["flat"] = np.asarray(jcc.conv_flat(jxf, jw, h, W).astype(jnp.float32))
    out["fused"] = np.asarray(jcc.conv_flat_bn_relu(
        jxf, jw, jnp.asarray(mul), jnp.asarray(add), h, W).astype(jnp.float32))
    out["conv3x3"] = np.asarray(jcc.conv3x3_cmajor(jx, jw).astype(jnp.float32))

    def loss(a, b):
        yf = jcc.conv_flat_vjp(jcc.pad_flat(a.astype(jnp.bfloat16)),
                               b.astype(jnp.bfloat16), h, W)
        return jnp.sum(jcc.unflat(yf, h, W).astype(jnp.float32) * g)

    dx, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    out["dx"], out["dw"] = np.asarray(dx), np.asarray(dw)
    return out


def test_pad_flat_and_unflat_match_jax(case):
    h = case["h"]
    xf = tcc.pad_flat(_t(case["x"]))
    assert xf.dtype == torch.bfloat16 and xf.shape == (D, CIN, (h + 2) * W)
    np.testing.assert_array_equal(_np(xf), case["xf"])
    np.testing.assert_array_equal(_np(tcc.unflat(xf, h, W)), case["x"])


def test_conv_flat_matches_jax_with_zero_output_halos(case):
    h = case["h"]
    got = tcc.conv_flat(_t(case["xf"], torch.bfloat16), _t(case["w"]), h, W)
    assert got.dtype == torch.bfloat16 and got.shape == case["flat"].shape
    assert _rel(_np(got), case["flat"]) < REL_L2
    assert (_np(got)[:, :, :W] == 0).all()
    assert (_np(got)[:, :, (h + 1) * W:] == 0).all()


def test_input_halo_garbage_changes_nothing(case):
    h = case["h"]
    w = _t(case["w"])
    clean = tcc.conv_flat(_t(case["xf"], torch.bfloat16), w, h, W)
    dirty = tcc.conv_flat(_t(_garbage_halos(case["xf"], h), torch.bfloat16),
                          w, h, W)
    assert torch.equal(clean, dirty)
    mul, add = _t(case["mul"]), _t(case["add"])
    assert torch.equal(
        tcc.conv_flat_bn_relu(_t(case["xf"], torch.bfloat16), w, mul, add,
                              h, W),
        tcc.conv_flat_bn_relu(_t(_garbage_halos(case["xf"], h),
                                 torch.bfloat16), w, mul, add, h, W))


def test_conv_flat_bn_relu_matches_jax(case):
    """The fold: `w * mul` in float32, rounded to bfloat16, then shift and
    clamp on the accumulator; output halos stay zero under a non-zero
    shift."""
    h = case["h"]
    got = _np(tcc.conv_flat_bn_relu(
        _t(case["xf"], torch.bfloat16), _t(case["w"]), _t(case["mul"]),
        _t(case["add"]), h, W))
    assert _rel(got, case["fused"]) < REL_L2
    assert (got[:, :, :W] == 0).all() and (got[:, :, (h + 1) * W:] == 0).all()
    assert (got >= 0).all()


def test_conv3x3_cmajor_matches_jax(case):
    x = _t(case["x"])
    got = tcc.conv3x3_cmajor(x, _t(case["w"]))
    assert got.dtype == x.dtype and got.shape == case["conv3x3"].shape
    assert _rel(_np(got), case["conv3x3"]) < REL_L2
    assert tcc.conv3x3_cmajor_vjp is tcc.conv3x3_cmajor


def test_gradients_match_jax_grad_of_conv_flat_vjp(case):
    h = case["h"]
    x = _t(case["x"]).requires_grad_()
    w = _t(case["w"]).requires_grad_()
    yf = tcc.conv_flat_vjp(tcc.pad_flat(x), w, h, W)
    (tcc.unflat(yf, h, W).float() * _t(case["g"])).sum().backward()
    assert _rel(_np(x.grad), case["dx"]) < REL_L2
    assert _rel(_np(w.grad), case["dw"]) < REL_L2


def test_cotangent_halo_garbage_is_ignored_and_dx_halos_are_zero(case):
    h = case["h"]
    w = _t(case["w"])
    clean = np.zeros((D, COUT, (h + 2) * W), np.float32)
    clean[:, :, W:-W] = case["g"].reshape(D, COUT, h * W)
    dirty = clean.copy()
    dirty[:, :, :W] = 1e4
    dirty[:, :, (h + 1) * W:] = -1e4
    grads = []
    for cot in (clean, dirty):
        xf = _t(case["xf"], torch.bfloat16).requires_grad_()
        yf = tcc.conv_flat(xf, w, h, W)
        (dxf,) = torch.autograd.grad(yf, xf, _t(cot, torch.bfloat16))
        grads.append(dxf)
    assert torch.equal(grads[0], grads[1])
    dx = _np(grads[0])
    assert (dx[:, :, :W] == 0).all() and (dx[:, :, (h + 1) * W:] == 0).all()


# ---------------------------------------------------------------- port only
@pytest.mark.parametrize("d,cin,cout,h,w", [
    (1, 1, 5, 3, 8), (2, 6, 5, 24, 104), (1, 17, 33, 5, 16), (3, 5, 1, 9, 136)])
def test_any_shape_against_float32_conv(d, cin, cout, h, w):
    """No tile or channel multiple is asked for, and of the width only a
    multiple of 8 (the TPU kernel needs W % 128 == 0 and a tile height that
    divides H)."""
    rng = np.random.default_rng(cin * 100 + w)
    x = _t(_bf16(rng.standard_normal((d, cin, h, w)).astype(np.float32)))
    wt = _t(_bf16((rng.standard_normal((3, 3, cin, cout)) / (3 * cin ** 0.5))
                  .astype(np.float32)))
    assert tcc.supports(x.shape, wt.shape)
    ref = torch.nn.functional.conv2d(x, wt.permute(3, 2, 0, 1), padding=1)
    got = tcc.conv3x3_cmajor(x, wt)
    assert _rel(_np(got), _np(ref)) < REL_L2


@pytest.mark.parametrize("width", [7, 100, 130])
def test_widths_off_the_8_grid_are_refused(width):
    """The kernel's TMA copies want 16-byte row strides: `supports` says no,
    and the wrapper raises before it looks at the device."""
    assert not tcc.supports((D, CIN, 24, width), (3, 3, CIN, COUT))
    xf = torch.zeros((D, CIN, 26 * width), dtype=torch.bfloat16)
    w = torch.zeros((3, 3, CIN, COUT), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        conv_cmajor_cuda.conv_flat_cuda(xf, w, None, 24, width)


@pytest.mark.parametrize("cin,cout", [(1, 5), (17, 33), (32, 72), (16, 8)])
def test_pack_weights_matches_a_numpy_arrangement(cin, cout):
    """(3, 3, Cin, Cout) HWIO -> (9, ceil(Cin/16), Cout rounded up to 8, 16):
    [tap][chunk][co][ci], zeros where ci >= Cin or co >= Cout."""
    rng = np.random.default_rng(cin * 1000 + cout)
    w = _bf16(rng.standard_normal((3, 3, cin, cout)).astype(np.float32))
    nch, cout8 = -(-cin // 16), -(-cout // 8) * 8
    want = np.zeros((9, nch, cout8, 16), np.float32)
    for dy in range(3):
        for dx in range(3):
            for ci in range(cin):
                for co in range(cout):
                    want[3 * dy + dx, ci // 16, co, ci % 16] = \
                        w[dy, dx, ci, co]
    got = conv_cmajor_cuda.pack_weights(_t(w, torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    np.testing.assert_array_equal(_np(got), want)


def test_tiles_cover_any_cout():
    """A block takes up to 256 output channels; more go to further blocks,
    which the grid check counts."""
    assert [conv_cmajor_cuda.tile(c) for c in (1, 16, 17, 32, 64, 65, 128,
                                                129, 256, 300)] == [
        (16, 8), (16, 8), (32, 8), (32, 8), (64, 8), (128, 4), (128, 4),
        (256, 2), (256, 2), (256, 2)]
    assert conv_cmajor_cuda.grid_fits(65535, 256, 2 * 65535)
    assert not conv_cmajor_cuda.grid_fits(1, 256, 2 * 65535 + 1)
    assert not conv_cmajor_cuda.grid_fits(65535, 257, 8)
    assert not conv_cmajor_cuda.grid_fits(1, 32, 8 * 65535 + 1)


def test_supports():
    assert tcc.supports((D, CIN, 24, 128), (3, 3, CIN, COUT))
    assert tcc.supports((D, CIN, 24, 104), (3, 3, CIN, COUT))   # W % 8 == 0
    assert not tcc.supports((D, CIN, 24, 100), (3, 3, CIN, COUT))
    assert not tcc.supports((D, CIN, 24, 128), (5, 5, CIN, COUT))  # 3x3 only
    assert not tcc.supports((D, CIN, 24, 128), (3, 3, CIN + 1, COUT))
    assert not tcc.supports((CIN, 24, 128), (3, 3, CIN, COUT))
    assert not tcc.supports((70000, CIN, 24, 128), (3, 3, CIN, COUT))  # grid


def test_wrong_shapes_raise():
    xf = torch.zeros((1, 2, 5 * 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="weights"):
        tcc.conv_flat(xf, torch.zeros((3, 3, 3, 2)), 3, 4)
    with pytest.raises(ValueError, match="padded-flat"):
        tcc.conv_flat(xf, torch.zeros((3, 3, 2, 2)), 4, 4)
    with pytest.raises(ValueError, match="mul"):
        tcc.conv_flat_bn_relu(xf, torch.zeros((3, 3, 2, 2)), torch.ones(3),
                              torch.ones(2), 3, 4)


def test_cpu_tensors_never_count_as_kernel_launches():
    before = conv_cmajor_cuda.launches
    tcc.conv3x3_cmajor(torch.zeros((1, 2, 4, 4)), torch.zeros((3, 3, 2, 2)))
    assert conv_cmajor_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        conv_cmajor_cuda.conv_flat_cuda(
            torch.zeros((1, 2, 48), dtype=torch.bfloat16),
            torch.zeros((3, 3, 2, 2), dtype=torch.bfloat16), None, 4, 8)
