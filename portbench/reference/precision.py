"""Operand roundings for the control: the reference in the program's place
at the precision below the one the configuration states (its
`compute_dtype`, `control`).

Below bfloat16 or float16 convs and matmuls is float8 (e4m3) with a scale
per tensor, as a float8 training or serving path would take it: each
operand divided by amax / 448, rounded to e4m3, scaled back. The rounding
is applied in the forward; the backward passes the gradient straight
through (the rounding has no derivative).
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = amax / E4M3_MAX
    r = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (r - x.detach()) if x.requires_grad else r


# the step below each compute type that a configuration may state
BELOW = {"bfloat16": fp8_e4m3, "float16": fp8_e4m3}


def control(cfg: dict):
    """The rounding of the control for the configuration's compute type."""
    if cfg["compute_dtype"] not in BELOW:
        raise ValueError(f"no control below {cfg['compute_dtype']!r}")
    return BELOW[cfg["compute_dtype"]]
