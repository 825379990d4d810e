"""The channel-major conv as the custom operator `qea_ocr::conv_flat`
(`qea_ocr_tpu_torch/ops/conv_cmajor.py`), on the CPU.

The operator passes `torch.library.opcheck` (schema, fake rule, autograd
registration, AOT dispatch) with and without the epilogue's shift, and its
CPU result is the plain version's, bitwise. A channel-major UNet(4) at
16x256, traced by `torch.export`, holds one operator node a conv (8), and
the artifact, loaded by a fresh interpreter that imports nothing of the port
but the operator's module, gives the eager channel-major forward bitwise (on
the CPU both run the plain version on the same bfloat16 operands). The JAX
side of the conv is held in `tests/test_torch_conv_cmajor.py` and
`tests/test_torch_cmajor_unet.py`, whose entry points now go through the
operator.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qea_ocr_tpu_torch.models.unet import UNet, cmajor_supported
from qea_ocr_tpu_torch.ops import conv_cmajor as cc
from qea_ocr_tpu_torch.tools.export_model import conv_flat_nodes

import _torch_parity  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parents[1]
D, CIN, COUT, H, W = 2, 6, 5, 8, 16
DOC = (16, 256)
OP = torch.ops.qea_ocr.conv_flat.default


def _operands(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((D, CIN, H, W), np.float32))
    w = torch.from_numpy(0.1 * rng.standard_normal((3, 3, CIN, COUT))
                         ).float()
    shift = torch.from_numpy(rng.standard_normal(COUT).astype(np.float32))
    return cc.pad_flat(x), w.to(torch.bfloat16), shift


@pytest.mark.parametrize("with_shift", [False, True],
                         ids=["plain", "shift"])
def test_opcheck(with_shift):
    xf, w, shift = _operands(0)
    result = torch.library.opcheck(
        OP, (xf, w, shift if with_shift else None, H, W))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("with_shift", [False, True],
                         ids=["plain", "shift"])
def test_cpu_result_is_the_plain_version(with_shift):
    xf, w, shift = _operands(1)
    s = shift if with_shift else None
    got = OP(xf, w, s, H, W)
    want = cc.conv_flat_plain(xf, w, s, H, W)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got, want)
    # the module's entry points reach the same result through the operator
    if with_shift:
        mul = torch.ones(COUT)
        assert torch.equal(cc.conv_flat_bn_relu(xf, w, mul, shift, H, W),
                           want)
    else:
        assert torch.equal(cc.conv_flat(xf, w, H, W), want)


def test_gradient_rule_through_the_operator():
    """dX is the operator on the rotated weights, dW the plain
    weight-gradient conv: both as before the registration."""
    xf, w, _ = _operands(2)
    xf = xf.float().requires_grad_()
    w = w.float().requires_grad_()
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (D, COUT, (H + 2) * W)).astype(np.float32))
    (cc.conv_flat(xf, w, H, W).float() * g).sum().backward()
    g16 = g.to(torch.bfloat16)
    want_dx = cc.conv_flat_plain(g16, cc._rot_w(w.detach()), None, H, W)
    assert torch.equal(xf.grad, want_dx.float())
    x = cc.unflat(xf.detach().to(torch.bfloat16), H, W).float()
    want_dw = torch.nn.grad.conv2d_weight(
        x, (COUT, CIN, 3, 3), cc.unflat(g16, H, W).float(), padding=1)
    assert torch.equal(w.grad, want_dw.permute(2, 3, 1, 0))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A channel-major UNet(4) with random batch norms, its eager forward on
    a seeded input, and its artifact on disk."""
    assert cmajor_supported(*DOC, 4, 2)
    model = UNet(init_features=4, conv_impl="cmajor",
                 generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    for bn in (m for m in model.modules()
               if isinstance(m, torch.nn.BatchNorm2d)):
        c = bn.num_features
        bn.running_mean.copy_(torch.from_numpy(
            rng.normal(0, 0.2, c).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(
            rng.uniform(0.5, 2.0, c).astype(np.float32)))
    model.eval()
    x = torch.from_numpy(rng.random((2, 1, *DOC), np.float32))
    with torch.no_grad():
        want = model(x)
        ep = torch.export.export(model, (x,))
    tmp = tmp_path_factory.mktemp("conv_op")
    torch.export.save(ep, tmp / "unet.pt2")
    np.save(tmp / "x.npy", x.numpy())
    return dict(ep=ep, x=x, want=want, dir=tmp)


def test_export_holds_one_node_a_conv(exported):
    assert conv_flat_nodes(exported["ep"]) == 8
    loaded = torch.export.load(exported["dir"] / "unet.pt2")
    assert conv_flat_nodes(loaded) == 8
    with torch.no_grad():
        got = loaded.module()(exported["x"])
    assert torch.equal(got, exported["want"])


def test_artifact_loads_with_the_operator_module_only(exported):
    """A fresh interpreter, the repository root put on `sys.path` by hand,
    imports the operator's module and nothing else of the port, and runs the
    artifact."""
    code = (
        "import sys, numpy as np, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import qea_ocr_tpu_torch.ops.conv_cmajor\n"
        "port = sorted(m for m in sys.modules\n"
        "              if m.startswith('qea_ocr_tpu_torch'))\n"
        "assert port == ['qea_ocr_tpu_torch', 'qea_ocr_tpu_torch.ops',\n"
        "                'qea_ocr_tpu_torch.ops.conv_cmajor',\n"
        "                'qea_ocr_tpu_torch.ops.cuda',\n"
        "                'qea_ocr_tpu_torch.ops.cuda.build',\n"
        "                'qea_ocr_tpu_torch.ops.cuda.conv_cmajor_cuda'], port\n"
        "m = torch.export.load('unet.pt2').module()\n"
        "with torch.no_grad():\n"
        "    y = m(torch.from_numpy(np.load('x.npy')))\n"
        "np.save('y.npy', y.float().numpy())\n")
    proc = subprocess.run([sys.executable, "-I", "-c", code],
                          cwd=exported["dir"], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = np.load(exported["dir"] / "y.npy")
    np.testing.assert_array_equal(got, exported["want"].float().numpy())


def test_artifact_needs_the_operator_registered(exported):
    """Without the operator's module the artifact does not load."""
    code = ("import torch\n"
            "try:\n"
            "    torch.export.load('unet.pt2')\n"
            "except Exception as e:\n"
            "    print('refused', type(e).__name__)\n"
            "else:\n"
            "    print('loaded')\n")
    proc = subprocess.run([sys.executable, "-I", "-c", code],
                          cwd=exported["dir"], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("refused"), proc.stdout
