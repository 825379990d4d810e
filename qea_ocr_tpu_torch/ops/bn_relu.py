"""Batch norm then ReLU as one operation with its own backward: the UNet's
library route normalises each conv output with it (`models/unet.py`).

`bn_relu(y, bn, group_sum, numel)` is `relu(bn(y))` in y's dtype, with
float32 statistics and arithmetic. `bn` is an `nn.BatchNorm2d` with float32
weight, bias and running statistics:

  * train mode normalises with the batch's mean and *biased* variance and
    moves the running statistics by flax's rule, `new = (1 - momentum) *
    old + momentum * batch` (`move_running`), in place, counting
    `num_batches_tracked`. Inside `multihost.data_group` the batch is the
    group's: the ranks' moments are combined by Chan's formula through two
    sums over the group, `sum(n_r * mean_r)` and then `sum(M2_r + n_r *
    (mean_r - mean)^2)` (float64, `group_sum`; the rows a channel over the
    group from `numel`), so every rank moves its statistics by the same
    numbers; the backward sums its two per-channel sums over the group
    before dx, and returns this rank's own sums as the weight and bias
    gradients (`sum_gradients` adds the ranks' afterwards);
  * eval mode normalises with the running statistics. It has no backward:
    nothing trains a frozen UNet, and asking for its gradient raises.

The arithmetic, per channel (`csrc/bn_relu.cu` says it in full):
`scale = w / sqrt(var + eps)`, `shift = b - mean * scale`, `z =
relu(y * scale + shift)` rounded to y's dtype; backward with `g = dz` where
z > 0, `xhat = (y - mean) / sqrt(var + eps)`: `dbias = sum g`, `dweight =
sum g * xhat`, `dx = scale * (g - sum g / n - xhat * sum g * xhat / n)`.
Only y and four floats a channel are saved for the backward: the mask is
y's, recomputed.

A CPU tensor takes the plain version below (the same steps in PyTorch,
the statistics merged in float64 as the kernels merge theirs); a CUDA tensor
launches the kernels of `ops/cuda/bn_relu_cuda.py` or raises; any other
device raises. On CUDA an eval-mode norm is one custom operator,
`torch.ops.qea_ocr.bn_relu_eval(y, weight, bias, running_mean,
running_var, eps)`, registered here with `torch.library.custom_op` (its one
implementation dispatches by device as above; its fake rule gives the
output without running anything), so that `torch.export` writes it into the
graph as one node a norm and the exported UNet still runs the kernels.
Loading such an artifact needs the operator registered first: `import
qea_ocr_tpu_torch.ops.bn_relu` before `torch.export.load`. On the CPU the
plain steps are traced instead, standard operators only. A train-mode norm
on CUDA does not export (its running statistics move in place) and raises.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
from torch import nn

from qea_ocr_tpu_torch.ops.cuda import bn_relu_cuda
from qea_ocr_tpu_torch.parallel.multihost import current_group, data_group


def move_running(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor,
                 var_weight: float) -> None:
    """flax's running-statistics rule, `new = (1 - momentum) * old +
    momentum * batch`, with the biased batch variance: `var_weight` is the
    weight of `var` as given (`momentum` for the biased variance)."""
    with torch.no_grad():
        bn.running_mean.mul_(1 - bn.momentum).add_(mean, alpha=bn.momentum)
        bn.running_var.mul_(1 - bn.momentum).add_(var, alpha=var_weight)
        bn.num_batches_tracked += 1


# ------------------------------------------------------------ plain steps

def _channel(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-channel (C,) tensor shaped to broadcast over (N, C, ...)."""
    return t.reshape((1, -1) + (1,) * (ndim - 2))


def _dims(y: torch.Tensor) -> list:
    return [0, *range(2, y.dim())]


def _moments_plain(y: torch.Tensor):
    """y's (mean, M2) as one partial, two passes in float32."""
    yf = y.float()
    mean = yf.mean(dim=_dims(y))
    m2 = (yf - _channel(mean, y.dim())).square().sum(dim=_dims(y))
    rows = y.numel() // y.shape[1]
    return (torch.stack([mean, m2])[None],
            torch.tensor([float(rows)], dtype=torch.float64))


def _merge(part: torch.Tensor, counts: torch.Tensor):
    """Chan's merge of the partials, in order, in float64: (n, mean, M2)."""
    n = 0.0
    mean = torch.zeros(part.shape[2], dtype=torch.float64, device=part.device)
    m2 = torch.zeros_like(mean)
    for p, nb in enumerate(counts.tolist()):
        if nb > 0:
            nn_ = n + nb
            f = nb / nn_
            d = part[p, 0].double() - mean
            mean = mean + d * f
            m2 = m2 + part[p, 1].double() + d * d * (n * f)
            n = nn_
    return n, mean, m2


def _merged_plain(part, counts) -> torch.Tensor:
    _, mean, m2 = _merge(part, counts)
    return torch.stack([mean, m2]).float()


def _finalise_plain(part, counts, bn, weight, bias, move: bool):
    """(mean, invstd, scale, shift) (4, C) from the partials, or from the
    running statistics where `part` is None; with `move` the running
    statistics moved."""
    if part is None:
        mean = bn.running_mean.float()
        var = bn.running_var.double()
    else:
        n, mean64, m2 = _merge(part, counts)
        mean, var = mean64.float(), m2 / n
    invstd = (1.0 / torch.sqrt(var + bn.eps)).float()
    scale = weight.detach() * invstd
    shift = bias.detach() - mean * scale
    if move:
        move_running(bn, mean, var.float(), bn.momentum)
    return torch.stack([mean, invstd, scale, shift])


def _apply_plain(y: torch.Tensor, stat: torch.Tensor) -> torch.Tensor:
    return torch.relu(y.float() * _channel(stat[2], y.dim())
                      + _channel(stat[3], y.dim())).to(y.dtype)


def _masked(dz, y, stat) -> torch.Tensor:
    """g: dz where the forward's z is positive, float32."""
    return torch.where(_apply_plain(y, stat) > 0, dz.float(), 0.0)


def _grad_sums_plain(dz, y, stat) -> torch.Tensor:
    g = _masked(dz, y, stat)
    xhat = ((y.float() - _channel(stat[0], y.dim()))
            * _channel(stat[1], y.dim()))
    return torch.stack([g.sum(dim=_dims(y)), (g * xhat).sum(dim=_dims(y))])


def _grad_input_plain(dz, y, stat, sums, n: int) -> torch.Tensor:
    g = _masked(dz, y, stat)
    scale = _channel(stat[2], y.dim())
    k1 = (sums[0].double() / n).float()
    k2 = stat[1] * (sums[1].double() / n).float()
    dev = y.float() - _channel(stat[0], y.dim())
    return (scale * (g - _channel(k1, y.dim()) - dev * _channel(k2, y.dim()))
            ).to(y.dtype)


_PLAIN = SimpleNamespace(
    rows_view=lambda t: t, moments=_moments_plain, merged=_merged_plain,
    finalise=_finalise_plain, apply=_apply_plain,
    grad_sums=_grad_sums_plain, grad_input=_grad_input_plain)


def _steps(t: torch.Tensor):
    """The steps for t's device: the plain ones for the CPU, the kernels
    for CUDA."""
    if t.device.type == "cpu":
        return _PLAIN
    if t.device.type == "cuda":
        if torch.compiler.is_exporting():
            raise RuntimeError("only an eval-mode batch norm + ReLU exports "
                               "on CUDA (the `qea_ocr::bn_relu_eval` "
                               "operator): put the model in eval mode")
        return bn_relu_cuda
    raise ValueError(f"no batch norm + ReLU for device {t.device}")


# --------------------------------------------------- the eval-mode operator

@torch.library.custom_op(
    "qea_ocr::bn_relu_eval", mutates_args=(),
    schema="(Tensor y, Tensor weight, Tensor bias, Tensor running_mean, "
           "Tensor running_var, float eps) -> Tensor")
def bn_relu_eval_op(y: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, running_mean: torch.Tensor,
                    running_var: torch.Tensor, eps: float) -> torch.Tensor:
    """relu(bn(y)) with the running statistics, channels-last in y's
    dtype; no gradient. Dispatches by y's device (`_steps`)."""
    k = _steps(y)
    y = k.rows_view(y)
    running = SimpleNamespace(running_mean=running_mean,
                              running_var=running_var, eps=eps, momentum=0.0)
    stat = k.finalise(None, None, running, weight, bias, move=False)
    return k.apply(y, stat).contiguous(memory_format=torch.channels_last)


@bn_relu_eval_op.register_fake
def _bn_relu_eval_fake(y, weight, bias, running_mean, running_var, eps):
    return torch.empty_like(y, memory_format=torch.channels_last)


# ----------------------------------------------------------- the operation

def _statistics(k, y: torch.Tensor, bn: nn.BatchNorm2d, weight, bias,
                group_sum, numel):
    """(mean, invstd, scale, shift) (4, C) for bn's mode (module
    docstring); in train mode the running statistics move."""
    if not bn.training:
        return k.finalise(None, None, bn, weight, bias, move=False)
    part, counts = k.moments(y)
    if current_group() is not None:
        rows = y.numel() // y.shape[1]
        mean_r, m2_r = k.merged(part, counts).double()
        n = numel(rows)
        mean = group_sum(mean_r * rows) / n
        m2 = group_sum(m2_r + rows * (mean_r - mean).square())
        part = torch.stack([mean, m2]).float()[None]
        counts = torch.full((1,), float(n), dtype=torch.float64,
                            device=part.device)
    return k.finalise(part, counts, bn, weight, bias, move=True)


class BnRelu(torch.autograd.Function):
    """relu(bn(y)) with its backward (module docstring). Inputs: y, bn's
    weight and bias (so autograd sees them), bn itself, and the group's sum
    and row count (`bn_relu`)."""

    @staticmethod
    def forward(ctx, y, weight, bias, bn, group_sum, numel):
        k = _steps(y)
        y = k.rows_view(y)
        stat = _statistics(k, y, bn, weight, bias, group_sum, numel)
        ctx.save_for_backward(y, stat)
        ctx.train = bn.training
        ctx.group, ctx.group_sum = current_group(), group_sum
        ctx.n = numel(y.numel() // y.shape[1])
        return k.apply(y, stat)

    @staticmethod
    def backward(ctx, dz):
        if not ctx.train:
            raise RuntimeError("an eval-mode batch norm + ReLU has no "
                               "backward: train the model in train mode")
        y, stat = ctx.saved_tensors
        need = ctx.needs_input_grad
        k = _steps(y)
        dz = k.rows_view(dz.to(y.dtype))
        sums = k.grad_sums(dz, y, stat)
        dx = None
        if need[0]:
            # the sums over the forward's group (identity outside one); the
            # parameters' gradients stay this rank's own
            with data_group(ctx.group):
                total = ctx.group_sum(sums)
            dx = k.grad_input(dz, y, stat, total, ctx.n)
        return (dx, sums[1] if need[1] else None,
                sums[0] if need[2] else None, None, None, None)


def bn_relu(y: torch.Tensor, bn: nn.BatchNorm2d, group_sum,
            numel) -> torch.Tensor:
    """relu(bn(y)) (module docstring): in eval mode on CUDA the operator
    `qea_ocr::bn_relu_eval`; else through `BnRelu` where autograd wants a
    gradient, or its forward alone. `group_sum(t)` sums a tensor over the
    current data group and `numel(n)` makes a rank's row count the group's
    (`multihost.global_sum_grad` and `global_numel`: the identity outside
    a group)."""
    params = (bn.weight, bn.bias)
    if not bn.training and y.device.type == "cuda":
        return bn_relu_eval_op(y, *params, bn.running_mean, bn.running_var,
                               bn.eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (y, *params)):
        return BnRelu.apply(y, *params, bn, group_sum, numel)
    k = _steps(y)
    y = k.rows_view(y)
    return k.apply(y, _statistics(k, y, bn, *params, group_sum, numel))
