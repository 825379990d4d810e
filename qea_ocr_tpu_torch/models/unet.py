"""UNet document cleaner (counterpart of the vanilla layout of
`qea_ocr_tpu/models/unet.py`).

Four encoder levels from `init_features` doubling each level, a bottleneck,
stride-2 transposed-conv upsampling with skip concats, and a 1x1 conv +
sigmoid output. Each block is conv3x3 (no bias) -> BatchNorm -> ReLU, twice.
Parameter names follow the reference schema (`encoder1.enc1conv1.weight`,
..., `upconv4`, `conv`), so a state_dict written by
`qea_ocr_tpu.tools.export_torch.state_dict_from_unet` loads with
`strict=True`.

Dtype policy, as in JAX: parameters are float32; convolutions run in
`compute_dtype` (bfloat16 by default) by casting input and weights
explicitly; eval-mode batch norm is applied in float32 to the conv output
and its result cast back to `compute_dtype`; the output sigmoid is float32.
The tensor-core-only layouts of the JAX package (`mxu_packed`,
channel-major Pallas blocks) are TPU compute rearrangements of the same
parameters and are not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


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
    with a bfloat16 `dtype` computes against float32 statistics)."""
    return bn(x.float()).to(x.dtype)


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


class UNet(nn.Module):
    """4-level UNet: (B, 1, H, W) float in [0, 1] -> (B, 1, H, W) float32
    sigmoid output. H and W must be divisible by 16."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 init_features: int = 32,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        f = init_features
        self.compute_dtype = compute_dtype
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        enc1 = self.encoder1(x, dt)
        enc2 = self.encoder2(F.max_pool2d(enc1, 2), dt)
        enc3 = self.encoder3(F.max_pool2d(enc2, 2), dt)
        enc4 = self.encoder4(F.max_pool2d(enc3, 2), dt)
        bottleneck = self.bottleneck(F.max_pool2d(enc4, 2), dt)
        dec4 = self.decoder4(torch.cat(
            [conv(self.upconv4, bottleneck, dt), enc4], 1), dt)
        dec3 = self.decoder3(torch.cat(
            [conv(self.upconv3, dec4, dt), enc3], 1), dt)
        dec2 = self.decoder2(torch.cat(
            [conv(self.upconv2, dec3, dt), enc2], 1), dt)
        dec1 = self.decoder1(torch.cat(
            [conv(self.upconv1, dec2, dt), enc1], 1), dt)
        return torch.sigmoid(conv(self.conv, dec1, dt).float())
