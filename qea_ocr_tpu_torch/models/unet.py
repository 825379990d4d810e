"""UNet document cleaner (counterpart of `qea_ocr_tpu/models/unet.py`).

Four encoder levels from `init_features` doubling each level, a bottleneck,
stride-2 transposed-conv upsampling with skip concats, and a 1x1 conv +
sigmoid output. Each block is conv3x3 (no bias) -> BatchNorm -> ReLU, twice.
Parameter names follow the reference schema (`encoder1.enc1conv1.weight`,
..., `upconv4`, `conv`), so a state_dict written by
`qea_ocr_tpu.tools.export_torch.state_dict_from_unet` loads with
`strict=True`.

Dtype policy, as in JAX: parameters are float32; convolutions run in
`compute_dtype` (bfloat16 by default) by casting input and weights
explicitly; batch norm is applied in float32 to the conv output (running
statistics in eval mode; batch statistics in train mode, see `batch_norm`)
and its result cast back to `compute_dtype`; the output sigmoid is float32.

Two compute layouts over one set of parameters, chosen by `conv_impl`:

* `"xla"` (the JAX package's name for the library route, kept so that flags
  and tests carry over): every conv goes to cuDNN through `F.conv2d`;
* `"cmajor"`: the shallow levels (enc1, enc2, dec2, dec1) stay in the
  padded-flat channel-major layout `(B, C, (H+2)*W)` and run their 3x3 convs
  through the hand-written kernel of `ops/conv_cmajor.py`
  (`flat_block`, the counterpart of `FlatConv3x3` / `FlatBatchNorm` /
  `FlatUNetBlock`). In eval mode each conv + batch norm + ReLU is one kernel
  launch (the scale folded into the weights, shift and clamp in the
  epilogue); in train mode, or with `QEA_CMAJOR_FUSED=0`, the chain is
  unfused and the batch statistics are sums over all lanes of the conv
  output, whose halo rows are zeros. The upconvs and the final 1x1 conv
  (`CMUpconv`, `CMFinalConv`: einsums outside the kernel in the JAX package)
  are `F.conv_transpose2d` / `F.conv2d`;
* `"auto"` reads `QEA_CONV_IMPL` when the model is built and resolves to
  `"xla"` unless it says `cmajor`.

A `"cmajor"` model given a geometry outside `cmajor_supported` raises,
whether the argument or the environment chose the route: it never gives way
to the library route.

Parameter and buffer names are the same for every value, so one
`state_dict` serves all. `UNet.twin(conv_impl)` returns a second module that
holds the *same* parameter and buffer tensors (not copies): the trainer's
no-grad forwards run through such a twin while the optimizer owns the
parameters through the first model. The `mxu_packed` space-to-depth twins of
the JAX package hold no kernel and are not ported.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from qea_ocr_tpu_torch.ops.conv_cmajor import (
    conv_flat, conv_flat_bn_relu, pad_flat, unflat)
from qea_ocr_tpu_torch.ops.cuda.conv_cmajor_cuda import grid_fits
from qea_ocr_tpu_torch.parallel.multihost import (
    current_group, global_numel, global_sum_grad)
from qea_ocr_tpu_torch.utils.metrics import backward_from, backward_to, span


def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Redraw every conv / linear weight and bias from `generator`,
    uniform in +-1/sqrt(fan_in) (torch's default bound); batch norm keeps
    weight 1, bias 0 and its running statistics."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """`bn` applied in float32, cast back to x's dtype (flax's BatchNorm
    with a bfloat16 `dtype` computes against float32 statistics).

    In train mode the batch's own statistics normalise, and the running
    statistics move by flax's rule, `new = (1 - momentum) * old + momentum *
    batch` with the *biased* batch variance (torch's module would store the
    unbiased one). The buffers are updated in place.

    Inside `multihost.data_group` the batch is the global one: the mean and
    then the variance are sums over every rank's rows, all-reduced through
    autograd (`global_batch_norm`)."""
    xf = x.float()
    if not bn.training:
        return bn(xf).to(x.dtype)
    if current_group() is not None:
        return global_batch_norm(bn, xf).to(x.dtype)
    # momentum 1 on scratch buffers leaves the batch's mean and its unbiased
    # variance in them
    mean = torch.zeros_like(bn.running_mean)
    var = torch.ones_like(bn.running_var)
    out = F.batch_norm(xf, mean, var, bn.weight, bn.bias, training=True,
                       momentum=1.0, eps=bn.eps)
    # the unbiased variance times (n-1)/n is the biased one
    n = xf.numel() // xf.shape[1]
    _move_running(bn, mean, var, bn.momentum * (n - 1) / n)
    return out.to(x.dtype)


def _move_running(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor,
                  var_weight: float) -> None:
    """flax's running-statistics rule, `new = (1 - momentum) * old +
    momentum * batch`, with the biased batch variance: `var_weight` is the
    weight of `var` as given (`momentum` for the biased variance)."""
    with torch.no_grad():
        bn.running_mean.mul_(1 - bn.momentum).add_(mean, alpha=bn.momentum)
        bn.running_var.mul_(1 - bn.momentum).add_(var, alpha=var_weight)
        bn.num_batches_tracked += 1


def global_batch_norm(bn: nn.BatchNorm2d, xf: torch.Tensor) -> torch.Tensor:
    """Train-mode `bn` on float32 `xf` (B, C, ...) with the statistics of
    the global batch of the current data group: the per-channel sum
    all-reduced for the mean, then the sum of squared deviations for the
    biased variance (two passes, as `F.batch_norm` is accurate to), both
    through `global_sum_grad`, so the backward runs through them. The
    running statistics move identically on every rank."""
    dims = [0, *range(2, xf.dim())]
    n = global_numel(xf.numel() // xf.shape[1])
    mean = global_sum_grad(xf.sum(dim=dims)) / n
    shape = (1, -1) + (1,) * (xf.dim() - 2)
    dev = xf - mean.reshape(shape)
    var = global_sum_grad((dev * dev).sum(dim=dims)) / n
    _move_running(bn, mean.detach(), var.detach(), bn.momentum)
    return (dev * torch.rsqrt(var + bn.eps).reshape(shape)
            * bn.weight.reshape(shape) + bn.bias.reshape(shape))


def conv(layer: nn.Conv2d | nn.ConvTranspose2d, x: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    """`layer` evaluated in `dtype` (input, weight and bias cast)."""
    w = layer.weight.to(dtype)
    b = None if layer.bias is None else layer.bias.to(dtype)
    if isinstance(layer, nn.ConvTranspose2d):
        return F.conv_transpose2d(x.to(dtype), w, b, stride=layer.stride)
    return F.conv2d(x.to(dtype), w, b, padding=layer.padding)


class UNetBlock(nn.Module):
    """(conv3x3 -> BN -> ReLU) x 2, with the reference's prefixed names
    (`{prefix}conv1`, `{prefix}norm1`, `{prefix}conv2`, `{prefix}norm2`)."""

    def __init__(self, in_channels: int, features: int, prefix: str):
        super().__init__()
        self.prefix = prefix
        for j, cin in ((1, in_channels), (2, features)):
            self.add_module(f"{prefix}conv{j}", nn.Conv2d(
                cin, features, 3, padding=1, bias=False))
            self.add_module(f"{prefix}norm{j}", nn.BatchNorm2d(
                features, eps=1e-5, momentum=0.1))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for j in (1, 2):
            x = conv(getattr(self, f"{self.prefix}conv{j}"), x, dtype)
            x = F.relu(batch_norm(getattr(self, f"{self.prefix}norm{j}"), x))
        return x


def fused_by_env() -> bool:
    return os.environ.get("QEA_CMAJOR_FUSED", "1").strip().lower() not in (
        "0", "false", "no", "off")


def flat_batch_norm(bn: nn.BatchNorm2d, xf: torch.Tensor | None, height: int,
                    width: int, dtype: torch.dtype, fold: bool = False):
    """`bn` over the channel axis of a padded-flat tensor (counterpart of
    `FlatBatchNorm`).

    `xf` must be a flat conv's output: its halo rows are zeros, so the sums
    over *all* lanes divided by the real element count B*H*W are the exact
    batch statistics, without a mask pass. The result's halo rows hold
    `add` (not zeros): a don't-care for the next flat conv, but any other
    consumer must go through `unflat`. In train mode the running statistics
    move by flax's rule with the biased batch variance, in place; inside
    `multihost.data_group` the sums are over the global batch. With
    `fold` (eval mode only) nothing is applied: the float32 `(mul, add)` are
    returned for the conv epilogue."""
    if bn.training:
        if fold:
            raise ValueError("fold needs running statistics (eval mode)")
        xs = xf.float()
        # real elements a channel, of the global batch in a data group
        n = global_numel(xf.shape[0] * height * width)
        mean = global_sum_grad(xs.sum(dim=(0, 2))) / n
        var = global_sum_grad((xs * xs).sum(dim=(0, 2))) / n - mean * mean
        _move_running(bn, mean.detach(), var.detach(), bn.momentum)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = bn.weight * torch.rsqrt(var + bn.eps)
    add = bn.bias - mean * mul
    if fold:
        return mul.float(), add.float()
    return (xf.to(dtype) * mul.to(dtype)[None, :, None]
            + add.to(dtype)[None, :, None])


def flat_block(block: "UNetBlock", xf: torch.Tensor, height: int, width: int,
               dtype: torch.dtype) -> torch.Tensor:
    """`block` ((conv3x3 -> BN -> ReLU) x 2) on a padded-flat tensor, staying
    padded-flat (counterpart of `FlatUNetBlock` with its `FlatConv3x3`s).

    Eval mode folds each batch norm and ReLU into its conv's kernel: two
    launches a block, no elementwise pass in between, output halo rows zero.
    `QEA_CMAJOR_FUSED=0` forces the unfused chain; train mode is always
    unfused (the batch statistics need the conv output) and leaves
    `relu(add)` on the halo rows."""
    fuse = not block.training and fused_by_env()
    for j in (1, 2):
        layer = getattr(block, f"{block.prefix}conv{j}")
        bn = getattr(block, f"{block.prefix}norm{j}")
        w = layer.weight.permute(2, 3, 1, 0)      # OIHW -> HWIO
        if fuse:
            mul, add = flat_batch_norm(bn, None, height, width, dtype,
                                       fold=True)
            xf = conv_flat_bn_relu(xf, w, mul, add, height, width)
        else:
            xf = F.relu(flat_batch_norm(
                bn, conv_flat(xf, w, height, width), height, width, dtype))
    return xf


def _flat_pool(xf: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Padded-flat (B, C, (H+2)*W) -> 2x2 max-pooled (B, C, H/2, W/2); the
    halo rows are dropped."""
    return F.max_pool2d(unflat(xf, height, width), 2)


def cmajor_supported(height: int, width: int, init_features: int,
                     batch: int = 1) -> bool:
    """Whether the channel-major route covers this geometry. The kernel
    takes any height, width and channel count; what is left is the UNet's
    own rule (four 2x2 pools: H and W divisible by 16) and the kernel's
    launch grid (batch x ceil(Cout / 64) and ceil(H / 8) within 65535)."""
    if height <= 0 or width <= 0 or height % 16 or width % 16:
        return False
    return init_features >= 1 and grid_fits(batch, 2 * init_features, height)


def resolve_conv_impl(conv_impl: str, height: int | None = None,
                      width: int | None = None, init_features: int = 1,
                      batch: int = 1) -> str:
    """`conv_impl` -> the route a UNet built now with it takes: `"xla"` or
    `"cmajor"`. `"auto"` defers to `QEA_CONV_IMPL` and resolves to `"xla"`
    unless that says `cmajor`: the kernel is opt-in, as in the JAX package.
    With a geometry, `"cmajor"` outside the route's coverage raises, whether
    the argument or the environment asked for it: the kernel's caller does
    not give way to the library route."""
    impl = conv_impl
    if impl == "auto":
        impl = os.environ.get("QEA_CONV_IMPL", "auto")
    if impl in ("xla", "auto"):
        return "xla"
    if impl != "cmajor":
        raise ValueError(f"unknown conv_impl {impl!r}: use auto, xla or "
                         "cmajor")
    if height is not None and not cmajor_supported(height, width,
                                                   init_features, batch):
        raise ValueError(f"conv_impl='cmajor' does not cover {batch} "
                         f"documents of {(height, width)} at "
                         f"f={init_features}")
    return "cmajor"


class UNet(nn.Module):
    """4-level UNet: (B, 1, H, W) float in [0, 1] -> (B, 1, H, W) float32
    sigmoid output. H and W must be divisible by 16."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 init_features: int = 32,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None,
                 conv_impl: str = "auto"):
        super().__init__()
        f = init_features
        self.compute_dtype = compute_dtype
        self.init_features = f
        self.in_channels, self.out_channels = in_channels, out_channels
        # read once, here: a later change of QEA_CONV_IMPL does not reroute
        # a model that exists
        self.conv_impl = resolve_conv_impl(conv_impl)
        self.encoder1 = UNetBlock(in_channels, f, "enc1")
        self.encoder2 = UNetBlock(f, f * 2, "enc2")
        self.encoder3 = UNetBlock(f * 2, f * 4, "enc3")
        self.encoder4 = UNetBlock(f * 4, f * 8, "enc4")
        self.bottleneck = UNetBlock(f * 8, f * 16, "bottleneck")
        self.upconv4 = nn.ConvTranspose2d(f * 16, f * 8, 2, stride=2)
        self.decoder4 = UNetBlock(f * 16, f * 8, "dec4")
        self.upconv3 = nn.ConvTranspose2d(f * 8, f * 4, 2, stride=2)
        self.decoder3 = UNetBlock(f * 8, f * 4, "dec3")
        self.upconv2 = nn.ConvTranspose2d(f * 4, f * 2, 2, stride=2)
        self.decoder2 = UNetBlock(f * 4, f * 2, "dec2")
        self.upconv1 = nn.ConvTranspose2d(f * 2, f, 2, stride=2)
        self.decoder1 = UNetBlock(f * 2, f, "dec1")
        self.conv = nn.Conv2d(f, out_channels, 1)
        reset_parameters(self, generator if generator is not None
                         else torch.Generator().manual_seed(0))

    def twin(self, conv_impl: str = "auto") -> "UNet":
        """A second UNet over this model's parameters and buffers: the same
        tensors, not copies, so it sees every optimizer step and every
        update of the running statistics. It has its own train/eval mode.
        Make it after the model has reached its device: `Module.to` swaps
        buffers for new tensors, which would cut the link (`shares_state`
        tells)."""
        other = UNet(self.in_channels, self.out_channels, self.init_features,
                     self.compute_dtype, conv_impl=conv_impl)
        mine = dict(self.named_modules())
        for name, sub in other.named_modules():
            for store in ("_parameters", "_buffers"):
                getattr(sub, store).update(getattr(mine[name], store))
        other.train(self.training)
        return other

    def shares_state(self, other: "UNet") -> bool:
        """Whether every parameter and buffer is the same tensor in both."""
        a = dict(self.named_parameters()) | dict(self.named_buffers())
        b = dict(other.named_parameters()) | dict(other.named_buffers())
        return a.keys() == b.keys() and all(a[k] is b[k] for k in a)

    def _use_cmajor(self, x: torch.Tensor) -> bool:
        return resolve_conv_impl(self.conv_impl, x.shape[2], x.shape[3],
                                 self.init_features, x.shape[0]) == "cmajor"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("unet.forward"):
            x = backward_to(x, "unet.backward")
            if self._use_cmajor(x):
                out = self._forward_cmajor(x)
            else:
                dt = self.compute_dtype
                enc1 = self.encoder1(x.to(dt), dt)
                enc2 = self.encoder2(F.max_pool2d(enc1, 2), dt)
                out = self._deep_and_decode(enc1, enc2)
            return backward_from(out, "unet.backward")

    def _deep_levels(self, pool2: torch.Tensor) -> torch.Tensor:
        """enc3 .. dec3 (always through the library) on pooled enc2."""
        dt = self.compute_dtype
        enc3 = self.encoder3(pool2, dt)
        enc4 = self.encoder4(F.max_pool2d(enc3, 2), dt)
        bottleneck = self.bottleneck(F.max_pool2d(enc4, 2), dt)
        dec4 = self.decoder4(torch.cat(
            [conv(self.upconv4, bottleneck, dt), enc4], 1), dt)
        return self.decoder3(torch.cat(
            [conv(self.upconv3, dec4, dt), enc3], 1), dt)

    def _deep_and_decode(self, enc1, enc2) -> torch.Tensor:
        dt = self.compute_dtype
        dec3 = self._deep_levels(F.max_pool2d(enc2, 2))
        dec2 = self.decoder2(torch.cat(
            [conv(self.upconv2, dec3, dt), enc2], 1), dt)
        dec1 = self.decoder1(torch.cat(
            [conv(self.upconv1, dec2, dt), enc1], 1), dt)
        return torch.sigmoid(conv(self.conv, dec1, dt).float())

    def _forward_cmajor(self, x: torch.Tensor) -> torch.Tensor:
        """The channel-major route: levels 1 and 2 padded-flat through the
        conv kernel, the deep levels as in `forward`."""
        dt = self.compute_dtype
        H, W = x.shape[2:]
        h2, w2 = H // 2, W // 2
        e1f = flat_block(self.encoder1, pad_flat(x), H, W, dt)
        e2f = flat_block(self.encoder2, pad_flat(_flat_pool(e1f, H, W)),
                         h2, w2, dt)
        dec3 = self._deep_levels(_flat_pool(e2f, h2, w2).to(dt))
        u2 = conv(self.upconv2, dec3, dt)                # (B, 2f, H/2, W/2)
        d2f = flat_block(self.decoder2, pad_flat(torch.cat(
            [u2, unflat(e2f, h2, w2).to(u2.dtype)], 1)), h2, w2, dt)
        u1 = conv(self.upconv1, unflat(d2f, h2, w2), dt)       # (B, f, H, W)
        # after an unfused block e1f's halo rows hold relu(add), not zeros:
        # a don't-care, the flat conv never reads its input's halo rows
        d1f = flat_block(self.decoder1, torch.cat(
            [pad_flat(u1), e1f.to(torch.bfloat16)], 1), H, W, dt)
        return torch.sigmoid(conv(self.conv, unflat(d1f, H, W), dt).float())
