"""Channel-major 3x3 SAME conv on padded-flat activations (counterpart of
`qea_ocr_tpu/ops/pallas/conv_cmajor.py`).

    Y[d, co, h, w] = sum_{dy, dx, ci} W[dy, dx, ci, co] * X[d, ci, h+dy-1, w+dx-1]

bfloat16 operands, float32 accumulation, bfloat16 output. Activations live
padded-flat as `(D, C, (H+2)*W)`: each channel plane with one halo row above
and one below the image. The halo contract is part of the function:

* the input's halo rows are never read: they count as zeros whatever they
  hold (an elementwise op between two convs may leave anything there);
* the output's halo rows are written as zeros, so a reduction over a conv
  output may sum all of it and divide by the real element count.

Weights are HWIO `(3, 3, Cin, Cout)`, as in the JAX package. Any Cin, Cout
and H are taken; on the card W must be a multiple of 8 (the kernel's TMA
copies want 16-byte row strides), where the JAX kernel wants 128.

Every entry point goes through one custom operator,
`torch.ops.qea_ocr.conv_flat(xf, w, shift, height, width)`, registered here
with `torch.library.custom_op`. Its one implementation dispatches by the
device of `xf`: a CUDA tensor launches the hand-written kernel of
`csrc/conv_cmajor.cu` (through `ops/cuda/conv_cmajor_cuda.py`) or raises; a
CPU tensor takes the plain version below. Its fake rule gives the output's
shape without running anything, so `torch.export` traces the channel-major
UNet into a graph that holds the operator as one node a conv. Loading such
an artifact needs the operator registered first: `import
qea_ocr_tpu_torch.ops.conv_cmajor` before `torch.export.load`. This module
imports only `torch` and `ops/cuda/*`.

Both routes are differentiable through one `torch.autograd.Function`: dX is
the same conv on the 180-degree-rotated weights with the channel axes
swapped, so it runs through the same operator, ignores cotangents on the
output's halo rows and has zero halo rows itself; dW is a plain PyTorch
weight-gradient convolution in float32 on the bfloat16-quantised operands
(the JAX package leaves dW to XLA too).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qea_ocr_tpu_torch.ops.cuda import conv_cmajor_cuda


def pad_flat(x: torch.Tensor) -> torch.Tensor:
    """(D, C, H, W) -> padded-flat (D, C, (H+2)*W) bfloat16 with a one-row
    zero halo above and below."""
    d, c, h, w = x.shape
    return F.pad(x.to(torch.bfloat16), (0, 0, 1, 1)).reshape(d, c, (h + 2) * w)


def unflat(xf: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Padded-flat (D, C, (H+2)*W) -> (D, C, H, W) (a view without the halo
    rows)."""
    d, c, _ = xf.shape
    return xf.reshape(d, c, height + 2, width)[:, :, 1:-1, :]


def supports(x_shape, w_shape) -> bool:
    """True when the kernel computes this conv: a 4-d input of at least one
    channel and a width that is a multiple of 8, a 3x3 HWIO kernel with
    matching input channels, and a launch grid the kernel can cover. No
    height or channel multiple is asked for."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    d, cin, h, w = x_shape
    if tuple(w_shape[:2]) != (3, 3) or w_shape[2] != cin or cin < 1:
        return False
    if w % conv_cmajor_cuda.WIDTH_MULTIPLE:
        return False
    return conv_cmajor_cuda.grid_fits(d, w_shape[3], h)


def conv_flat_plain(xf: torch.Tensor, w: torch.Tensor,
                    shift: torch.Tensor | None, height: int,
                    width: int) -> torch.Tensor:
    """The plain version: `F.conv2d` in float32 on the bfloat16-quantised
    operands, then the epilogue relu(y + shift) when `shift` is given, the
    cast, and the zero halo rows. xf (D, Cin, (H+2)*W), w (3, 3, Cin, Cout)."""
    x = unflat(xf.to(torch.bfloat16), height, width).float()
    w_oihw = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)
    y = F.conv2d(x, w_oihw, padding=1)
    if shift is not None:
        y = F.relu(y + shift.float()[None, :, None, None])
    y = y.to(torch.bfloat16)
    return F.pad(y, (0, 0, 1, 1)).reshape(y.shape[0], y.shape[1], -1)


@torch.library.custom_op(
    "qea_ocr::conv_flat", mutates_args=(),
    schema="(Tensor xf, Tensor w, Tensor? shift, SymInt height, "
           "SymInt width) -> Tensor")
def conv_flat_op(xf: torch.Tensor, w: torch.Tensor,
                 shift: torch.Tensor | None, height: int,
                 width: int) -> torch.Tensor:
    """The operator's implementation: dispatch by the device of `xf`, no
    gradient. A CUDA tensor launches the kernel or raises; a CPU tensor
    takes the plain version; any other device raises."""
    if xf.device.type == "cpu":
        return conv_flat_plain(xf, w, shift, height, width)
    if xf.device.type == "cuda":
        return conv_cmajor_cuda.conv_flat_cuda(
            xf.to(torch.bfloat16).contiguous(), w.to(torch.bfloat16),
            None if shift is None else shift.float().contiguous(),
            height, width)
    raise ValueError(f"no channel-major conv for device {xf.device}")


@conv_flat_op.register_fake
def _conv_flat_fake(xf, w, shift, height, width):
    return xf.new_empty((xf.shape[0], w.shape[3], (height + 2) * width),
                        dtype=torch.bfloat16)


def _conv_flat(xf: torch.Tensor, w: torch.Tensor, shift: torch.Tensor | None,
               height: int, width: int) -> torch.Tensor:
    """Check the shapes, then call the operator; no gradient."""
    if tuple(w.shape[:3]) != (3, 3, xf.shape[1]):
        raise ValueError(f"weights {tuple(w.shape)} do not fit activations "
                         f"{tuple(xf.shape)}: want (3, 3, Cin, Cout)")
    if xf.shape[2] != (height + 2) * width:
        raise ValueError(f"activations {tuple(xf.shape)} are not padded-flat "
                         f"for a {height}x{width} image")
    return conv_flat_op(xf, w, shift, height, width)


def _rot_w(w: torch.Tensor) -> torch.Tensor:
    """rot180 + in/out channel swap: the weights of the dX conv."""
    return w.flip(0, 1).permute(0, 1, 3, 2)


class _ConvFlat(torch.autograd.Function):
    """The padded-flat conv with its gradient."""

    @staticmethod
    def forward(ctx, xf, w, height, width):
        ctx.save_for_backward(xf, w)
        ctx.hw = (height, width)
        return _conv_flat(xf, w, None, height, width)

    @staticmethod
    def backward(ctx, gf):
        xf, w = ctx.saved_tensors
        height, width = ctx.hw
        dxf = dw = None
        g16 = gf.to(torch.bfloat16)
        if ctx.needs_input_grad[0]:
            # the same conv on the rotated weights; it ignores the halo rows
            # of the cotangent and writes zero halo rows
            dxf = _conv_flat(g16, _rot_w(w), None, height, width).to(xf.dtype)
        if ctx.needs_input_grad[1]:
            x = unflat(xf.to(torch.bfloat16), height, width).float()
            g = unflat(g16, height, width).float()
            cin, cout = w.shape[2:]
            dw = torch.nn.grad.conv2d_weight(
                x, (cout, cin, 3, 3), g, padding=1)       # OIHW
            dw = dw.permute(2, 3, 1, 0).to(w.dtype)
        return dxf, dw, None, None


def conv_flat(xf: torch.Tensor, w: torch.Tensor, height: int,
              width: int) -> torch.Tensor:
    """Padded-flat conv: xf (D, Cin, (H+2)*W), w (3, 3, Cin, Cout) HWIO
    -> (D, Cout, (H+2)*W) bfloat16. Differentiable in xf and w."""
    if torch.is_grad_enabled() and (xf.requires_grad or w.requires_grad):
        return _ConvFlat.apply(xf, w, height, width)
    return _conv_flat(xf, w, None, height, width)


# The JAX package keeps the differentiable conv under a second name.
conv_flat_vjp = conv_flat


def conv_flat_bn_relu(xf: torch.Tensor, w: torch.Tensor, mul: torch.Tensor,
                      add: torch.Tensor, height: int,
                      width: int) -> torch.Tensor:
    """Padded-flat conv with an eval-mode batch norm and ReLU folded in:
    `relu(conv(xf, w) * mul + add)` per output channel in one pass. The
    scale rides the weights (`w * mul` in float32, then rounded to bfloat16);
    the shift and the clamp are applied to the float32 accumulator. The
    output's halo rows stay zeros. No gradient, as in the JAX package:
    train-mode batch norm needs the conv output's own statistics."""
    cout = w.shape[-1]
    if tuple(mul.shape) != (cout,) or tuple(add.shape) != (cout,):
        raise ValueError(f"mul {tuple(mul.shape)} and add {tuple(add.shape)} "
                         f"must both be ({cout},)")
    w2 = (w.float() * mul.float()).to(torch.bfloat16)
    return _conv_flat(xf.detach(), w2.detach(), add.detach().float(),
                      height, width)


def conv3x3_cmajor(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Drop-in 3x3 SAME conv: (D, Cin, H, W), (3, 3, Cin, Cout) HWIO
    -> (D, Cout, H, W) in x's dtype. Pays the pad and unflat passes: chains
    of convs should stay padded-flat through `conv_flat`. Differentiable."""
    h, w_ = x.shape[2:]
    return unflat(conv_flat(pad_flat(x), w, h, w_), h, w_).to(x.dtype)


conv3x3_cmajor_vjp = conv3x3_cmajor
