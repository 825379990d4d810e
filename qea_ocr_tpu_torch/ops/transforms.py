"""On-device image transforms (counterpart of `qea_ocr_tpu/ops/transforms.py`).

  * `add_gaussian_noise`: subtractive gaussian jitter with an optional
    per-image stochastic std, vectorised over the batch (reference
    `transform_helper.py:26-45`, `AddGaussianNoice`).
  * `host_jitter`: the same jitter drawn on the host from a numpy
    generator, for images the black-box OCR must see exactly as the model
    trains on them (the trainers' `_noise`, bit for bit the JAX package's).
  * `pad_white_array`: the pure pad case of the reference's `PadWhite` for
    already-loaded arrays; resizing lives in the data layer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def add_gaussian_noise(images: torch.Tensor, std: int = 5, *,
                       stochastic: bool = True, noise_coef: float = 1.0,
                       mean: float = 0.0,
                       generator: torch.Generator | None = None,
                       image_std: torch.Tensor | None = None,
                       unit_noise: torch.Tensor | None = None,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Subtract gaussian noise and clamp to [0, 1]:
    `out = clamp(img - coef * (mean + std' * N(0, 1)))` with
    `std' = randint(0, std+1)/100` per image when `stochastic`, else
    `std/100`, plus the reference's 1e-13.

    images: (B, ...) float. Random numbers come from `generator` (on the
    images' device). Its stream is not JAX's, so a caller that must
    reproduce the JAX function's output passes its draws in: `image_std`
    (B,), the per-image std before the epsilon, and `unit_noise`, standard
    normal values of the images' shape.

    Returns (noisy images, noise), the reference's `return_noise=True` pair.
    """
    B = images.shape[0]
    dev = images.device
    if image_std is None:
        if stochastic:
            image_std = torch.randint(0, std + 1, (B,), generator=generator,
                                      device=dev).float() / 100.0
        else:
            image_std = torch.full((B,), float(std) / 100.0, device=dev)
    if unit_noise is None:
        unit_noise = torch.randn(images.shape, generator=generator,
                                 device=dev)
    r_std = image_std.float() + 1e-13
    noise = mean + unit_noise.float() * r_std.reshape(
        (B,) + (1,) * (images.dim() - 1))
    return torch.clamp(images - noise_coef * noise, 0.0, 1.0), noise


def host_jitter(rng: np.random.Generator, images: np.ndarray, std: int,
                random_std: bool) -> np.ndarray:
    """`clip(images - std' * N(0, 1), 0, 1)` in float32, with `std'` drawn
    per image from {0, .., std} / 100 when `random_std`, else std / 100: the
    stds first, then the normals, from `rng` (the JAX trainers' order)."""
    B = images.shape[0]
    if random_std:
        stds = rng.integers(0, std + 1, B) / 100.0
    else:
        stds = np.full(B, std / 100.0)
    noise = rng.normal(0.0, 1.0, images.shape).astype(np.float32)
    noise *= stds.reshape(B, *([1] * (images.ndim - 1))).astype(np.float32)
    return np.clip(images - noise, 0.0, 1.0)


def pad_white_array(img: torch.Tensor, height: int, width: int
                    ) -> torch.Tensor:
    """Centre-pad an (H, W) tensor to (height, width) with white (1.0).
    Larger images must be shrunk by the host data layer first."""
    h, w = img.shape
    pad_h, pad_w = height - h, width - w
    top, left = pad_h // 2, pad_w // 2
    return F.pad(img, (left, pad_w - left, top, pad_h - top), value=1.0)
