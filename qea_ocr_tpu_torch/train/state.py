"""Optimizers and learning-rate schedules (counterpart of
`qea_ocr_tpu/train/state.py`).

The reference uses `torch.optim.Adam(weight_decay=...)`: classic coupled L2
(gradient += wd * param, then Adam), not AdamW. The JAX package rebuilt
that from optax pieces; here it is the optimizer itself. A model's state is
the `nn.Module` (parameters and batch statistics) plus its optimizer
(moments and step count): there is no separate state object.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterable, Sequence

import torch


def adam_l2(params: Iterable[torch.nn.Parameter], learning_rate: float,
            weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam with coupled L2 decay on every parameter given (batch-norm
    scales and biases and LSTM biases too, as in the JAX package):
    betas (0.9, 0.999), eps 1e-8 outside the square root.

    Of torch's three implementations this takes the fused one for
    parameters on a CUDA device (one kernel per update instead of several
    per tensor) and the default elsewhere. All three compute the same
    update; `chip_smoke.py` holds a float32 step on the card against the
    same step on the CPU."""
    params = list(params)
    fused = bool(params) and all(p.is_cuda for p in params)
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay,
                            fused=fused or None)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group (the host-side
    schedule step, once per epoch)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def step_lr(base_lr: float, epoch: int, step_size: int = 10,
            gamma: float = 0.8) -> float:
    """torch StepLR parity."""
    return base_lr * (gamma ** (epoch // step_size))


def cosine_lr(base_lr: float, epoch: int, t_max: int) -> float:
    """torch CosineAnnealingLR parity (eta_min=0)."""
    return base_lr * (1 + math.cos(math.pi * epoch / t_max)) / 2


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor],
               params: Iterable[torch.nn.Parameter], decay: float) -> None:
    """`ema = decay * ema + (1 - decay) * params`, in place: the prep
    trainers' `prep_ema` average, one update after each phase-B step."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [p.detach() for p in params], alpha=1.0 - decay)


@contextlib.contextmanager
def parameters_swapped(model: torch.nn.Module,
                       values: Sequence[torch.Tensor]):
    """`model`'s parameters overwritten in place by `values` (in
    `parameters()` order) inside the block and restored after it. In place,
    so a twin over the same tensors (`UNet.twin`) sees the swap too."""
    params = list(model.parameters())
    raw = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p, v in zip(params, values):
            p.copy_(v)
    try:
        yield
    finally:
        with torch.no_grad():
            for p, r in zip(params, raw):
                p.copy_(r)
