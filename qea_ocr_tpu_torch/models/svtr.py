"""SVTR recognizer as an alternative CTC proxy (Du et al., "SVTR: Scene Text
Recognition with a Single Visual Model", IJCAI 2022, arXiv:2205.00159; the
code is PaddleOCR's `SVTRNet` backbone, `ppocr/modeling/backbones/
rec_svtrnet.py`, with a CTC head, in its English configurations'
`prenorm: false` form).

A (B, 1, 32, 128) crop becomes an 8x32 grid of patches; three stages of
transformer blocks run at 8x32, 4x32 and 2x32, joined by strided conv
merges; the last stage is pooled over its height to 32 columns, so the
output is time-major (T=32, B, V) float32 log-probs, as the CRNN returns
them (T=31 there).

  patch embedding  conv3x3/2 (1 -> d0/2) -> BN -> GELU -> conv3x3/2
                   (d0/2 -> d0) -> BN -> GELU, flattened row-major, plus a
                   learned position table
  block            x += Proj(Mix(LN1(x))); x += W2 GELU(W1 LN2(x) + b1) + b2
  Mix              q, k, v = split(x W_qkv + b_qkv) into heads of 32;
                   softmax(q k^T / sqrt(32) + M) v. M = 0 in a global
                   block; in a local block M[i, j] = 0 where |row_i - row_j|
                   <= 3 and |col_i - col_j| <= 5, else -inf: a 7x11 window
                   centred on the query, clipped at the grid's edge
  merge            conv3x3 stride (2, 1) with bias -> LN (epsilon 1e-5,
                   Paddle's default for the merges' norm)
  final            LN -> average pool over the rows -> conv1x1 (no bias)
                   -> Hardswish -> Linear(out -> V) -> log-softmax

Departures from the published model: one input channel (grey crops, not
RGB) at 32x128 (the system's crop; the published English input is 32x100
behind a rectification network, which is left out), so the grid is 8x32
and T = 32; the patch embedding's convs carry no bias (each is followed by
batch norm, whose shift takes its place); stochastic depth and the last
dropout (0.1 each in published training) are left out, as at rate 0, where
both are the identity.

Dtype policy, as the CRNN's: float32 parameters and residual stream; convs
and every linear layer in `compute_dtype` (bfloat16 by default); attention
through `F.scaled_dot_product_attention` on `compute_dtype` q, k, v;
LayerNorm, eval-mode batch norm (`unet.batch_norm`, so the proxy modes and
a data group's global statistics apply) and the log-softmax in float32.
The local mask is made once for each grid, window, device and type
(`window_mask`), never inside a step.

Spans: `svtr.forward` / `svtr.backward` around the model, `svtr.local` /
`svtr.global` around each run of consecutive blocks of one kind, and their
backwards `svtr.local.backward` / `svtr.global.backward`.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from qea_ocr_tpu_torch.models.unet import batch_norm
from qea_ocr_tpu_torch.utils.metrics import (
    backward_from, backward_to, on, span)

HEAD_DIM = 32

# the published preset (the paper's Table 1; PaddleOCR's configs): widths
# of the three stages, their depths and heads, how many of the 21 blocks
# (in order) are local, and the last conv's width
PRESETS = {
    "svtr-l": dict(dims=(192, 256, 512), depths=(3, 9, 9), heads=(6, 8, 16),
                   local_blocks=10, out_channels=384),
}


@functools.lru_cache(maxsize=None)
def window_mask(rows: int, cols: int, window: tuple[int, int],
                device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The local blocks' additive mask over a rows x cols grid (row-major
    tokens), (N, N): 0 where key j lies in the window centred on query i,
    -inf elsewhere. One tensor a grid, window, device and type."""
    r = torch.arange(rows * cols, device=device) // cols
    c = torch.arange(rows * cols, device=device) % cols
    near = (((r[:, None] - r[None, :]).abs() <= window[0] // 2)
            & ((c[:, None] - c[None, :]).abs() <= window[1] // 2))
    zero = torch.zeros((), device=device, dtype=dtype)
    return torch.where(near, zero, torch.full_like(zero, float("-inf")))


def linear(layer: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """`layer` in `dt` (input, weight and bias cast)."""
    b = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), b)


def conv2d(layer: nn.Conv2d, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    b = None if layer.bias is None else layer.bias.to(dt)
    return F.conv2d(x.to(dt), layer.weight.to(dt), b, stride=layer.stride,
                    padding=layer.padding)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


class Mixer(nn.Module):
    """Multi-head self-attention over the grid's tokens; `local` masks each
    query to its window (module docstring)."""

    def __init__(self, dim: int, heads: int, local: bool,
                 grid: tuple[int, int], window: tuple[int, int]):
        super().__init__()
        if dim != heads * HEAD_DIM:
            raise ValueError(f"{dim} wide over {heads} heads is not "
                             f"{HEAD_DIM} a head")
        self.heads, self.local = heads, local
        self.grid, self.window = grid, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        B, N, C = x.shape
        qkv = linear(self.qkv, x, dt).reshape(B, N, 3, self.heads, HEAD_DIM)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)     # (B, h, N, 32)
        mask = None
        if self.local:
            mask = window_mask(*self.grid, self.window, x.device, q.dtype)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return linear(self.proj, out.transpose(1, 2).reshape(B, N, C), dt)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, local: bool,
                 grid: tuple[int, int], window: tuple[int, int],
                 mlp_ratio: int, eps: float):
        super().__init__()
        self.local = local
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.mixer = Mixer(dim, heads, local, grid, window)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.fc1 = nn.Linear(dim, mlp_ratio * dim)
        self.fc2 = nn.Linear(mlp_ratio * dim, dim)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        a = self.mixer(layer_norm(self.norm1, x), dt)
        x = x + a.float()
        h = F.gelu(linear(self.fc1, layer_norm(self.norm2, x), dt))
        m = linear(self.fc2, h, dt)
        return x + m.float()


class Merge(nn.Module):
    """conv3x3 stride (2, 1) between two stages, then LN."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride=(2, 1), padding=1)
        self.norm = nn.LayerNorm(cout, eps=1e-5)

    def forward(self, x: torch.Tensor, grid: tuple[int, int],
                dt: torch.dtype) -> torch.Tensor:
        B, N, C = x.shape
        x = conv2d(self.conv, x.transpose(1, 2).reshape(B, C, *grid), dt)
        return layer_norm(self.norm, x.flatten(2).transpose(1, 2))


class SVTR(nn.Module):
    """(B, 1, 32, 128) crops -> (T, B, vocab_size) float32 log-probs, T the
    grid's width (32)."""

    def __init__(self, vocab_size: int, dims=(192, 256, 512),
                 depths=(3, 9, 9), heads=(6, 8, 16), local_blocks: int = 10,
                 out_channels: int = 384, window=(7, 11), mlp_ratio: int = 4,
                 eps: float = 1e-6, image_size=(32, 128),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embed_conv1 = nn.Conv2d(1, dims[0] // 2, 3, stride=2, padding=1,
                                     bias=False)
        self.embed_norm1 = nn.BatchNorm2d(dims[0] // 2, eps=1e-5,
                                          momentum=0.1)
        self.embed_conv2 = nn.Conv2d(dims[0] // 2, dims[0], 3, stride=2,
                                     padding=1, bias=False)
        self.embed_norm2 = nn.BatchNorm2d(dims[0], eps=1e-5, momentum=0.1)
        grid = (image_size[0] // 4, image_size[1] // 4)
        self.grids = (grid, (grid[0] // 2, grid[1]), (grid[0] // 4, grid[1]))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid[0] * grid[1],
                                                  dims[0]))
        self.stages = nn.ModuleList()
        i = 0
        for s, (dim, depth, h) in enumerate(zip(dims, depths, heads)):
            blocks = nn.ModuleList()
            for _ in range(depth):
                blocks.append(Block(dim, h, i < local_blocks, self.grids[s],
                                    tuple(window), mlp_ratio, eps))
                i += 1
            self.stages.append(blocks)
        self.merges = nn.ModuleList(
            [Merge(dims[0], dims[1]), Merge(dims[1], dims[2])])
        self.norm = nn.LayerNorm(dims[2], eps=eps)
        self.last_conv = nn.Conv2d(dims[2], out_channels, 1, bias=False)
        self.head = nn.Linear(out_channels, vocab_size)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))

    @classmethod
    def preset(cls, name: str, vocab_size: int, **kw) -> "SVTR":
        return cls(vocab_size, **PRESETS[name], **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Paddle's initialisation: linear weights and the position table
        normal with std 0.02 (truncated at 2 std there, not here), their
        biases 0; convs He-normal over fan-out (the merges' biases 0);
        norms weight 1 and bias 0."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    m.weight.normal_(0.0, 0.02, generator=generator)
                    m.bias.zero_()
                elif isinstance(m, nn.Conv2d):
                    fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                    m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                     generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def _runs(self, x: torch.Tensor, blocks, dt: torch.dtype):
        """The blocks of one stage, each run of consecutive blocks of one
        kind in a span of its own, with a span for its backward. While
        spans record, a run takes a view of the stream as its input, so
        that where two runs meet the later one's backward closes before
        the earlier one's opens (hooks on one tensor would run in the
        other order)."""
        i = 0
        while i < len(blocks):
            j = i
            while j < len(blocks) and blocks[j].local == blocks[i].local:
                j += 1
            name = "svtr.local" if blocks[i].local else "svtr.global"
            with span(name):
                if on():
                    x = backward_to(x.view_as(x), f"{name}.backward")
                for blk in blocks[i:j]:
                    x = blk(x, dt)
                x = backward_from(x, f"{name}.backward", nested=True)
            i = j
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("svtr.forward"):
            x = backward_to(x, "svtr.backward")
            dt = self.compute_dtype
            x = F.gelu(batch_norm(self.embed_norm1,
                                  conv2d(self.embed_conv1, x, dt)))
            x = F.gelu(batch_norm(self.embed_norm2,
                                  conv2d(self.embed_conv2, x, dt)))
            x = x.flatten(2).transpose(1, 2).float() + self.pos_embed
            for s, blocks in enumerate(self.stages):
                if s:
                    x = self.merges[s - 1](x, self.grids[s - 1], dt)
                x = self._runs(x, blocks, dt)
            x = layer_norm(self.norm, x)                      # (B, N, C)
            B, N, C = x.shape
            rows, cols = self.grids[-1]
            x = x.transpose(1, 2).reshape(B, C, rows, cols).mean(dim=2,
                                                                  keepdim=True)
            x = F.hardswish(conv2d(self.last_conv, x, dt))    # (B, O, 1, T)
            logits = linear(self.head, x.flatten(2).transpose(1, 2), dt)
            return backward_from(
                torch.log_softmax(logits.transpose(0, 1).float(), dim=2),
                "svtr.backward")
