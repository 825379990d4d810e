"""The plain reference of SVTR (Du et al., arXiv:2205.00159; PaddleOCR's
`SVTRNet`, `ppocr/modeling/backbones/rec_svtrnet.py`, `prenorm: false`,
with a CTC head): float32 PyTorch over a dict of tensors in the schema of
`portbench/weights_svtr.py`, written from the published equations. Nothing
here imports the program.

  patch embedding  conv3x3 stride 2 pad 1 (1 -> d0/2) -> batch norm (running
                   statistics: the trainers freeze the proxy's) -> GELU ->
                   conv3x3 stride 2 pad 1 (d0/2 -> d0) -> batch norm -> GELU;
                   tokens row-major, plus the position table
  block            x = x + proj(attn(LN1(x))); x = x + fc2(GELU(fc1(LN2(x))))
                   (LayerNorm epsilon 1e-6, exact GELU)
  attention        per head of 32: softmax(q k^T / sqrt(32) + M) v, the
                   softmax written out; M = 0 (global), or 0 inside the 7x11
                   window centred on the query and -inf outside it (local)
  merge            conv3x3 stride (2, 1) pad 1 with bias -> LayerNorm
                   (epsilon 1e-5)
  final            LayerNorm -> mean over the rows -> conv1x1 without bias ->
                   Hardswish -> linear -> log-softmax, time-major (T, B, V)

Departures from the published model, the same as the program's: one grey
input channel at 32x128 (so an 8x32 grid and T = 32; the published English
input is 32x100), no rectification network, stochastic depth and the last
dropout at rate 0 (so Paddle's inference-time down-scaling is the
identity), no bias on the patch embedding's convs (batch norm follows
each).

Every conv and matmul reads its operands through `q` (the identity; the
control rounds them), the attention's two products included. With
`checkpoint` each block is recomputed in the backward instead of kept (the
same numbers, a block's memory at a time)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench.reference.models import batch_norm

HEAD_DIM = 32
BLOCK_EPS = 1e-6
MERGE_EPS = 1e-5


def _ident(x):
    return x


def window_mask(rows: int, cols: int, window, device) -> torch.Tensor:
    """(N, N) float32: 0 where key j is inside the window centred on query
    i, -inf elsewhere."""
    mask = torch.full((rows * cols, rows * cols), float("-inf"))
    hr, hc = window[0] // 2, window[1] // 2
    for i in range(rows * cols):
        r, c = divmod(i, cols)
        for rr in range(max(0, r - hr), min(rows, r + hr + 1)):
            mask[i, rr * cols + max(0, c - hc):rr * cols
                 + min(cols, c + hc + 1)] = 0.0
    return mask.to(device)


def linear(x, sd, name, q=_ident):
    b = sd.get(f"{name}.bias")
    return F.linear(q(x), q(sd[f"{name}.weight"]), b)


def layer_norm(x, sd, name, eps):
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"],
                        sd[f"{name}.bias"], eps)


def attention(x, sd, name, heads, mask, q=_ident):
    B, N, C = x.shape
    qkv = linear(x, sd, f"{name}.qkv", q).reshape(B, N, 3, heads, HEAD_DIM)
    qh, kh, vh = qkv.permute(2, 0, 3, 1, 4)                # (B, h, N, 32)
    scores = q(qh) @ q(kh).transpose(-1, -2) / math.sqrt(HEAD_DIM)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = (q(probs) @ q(vh)).transpose(1, 2).reshape(B, N, C)
    return linear(out, sd, f"{name}.proj", q)


def block(x, sd, name, heads, mask, q=_ident):
    x = x + attention(layer_norm(x, sd, f"{name}.norm1", BLOCK_EPS), sd,
                      f"{name}.mixer", heads, mask, q)
    h = F.gelu(linear(layer_norm(x, sd, f"{name}.norm2", BLOCK_EPS), sd,
                      f"{name}.fc1", q))
    return x + linear(h, sd, f"{name}.fc2", q)


def svtr(x, sd, arch: dict, q=_ident, checkpoint: bool = False):
    """(B, 1, 32, 128) crops -> (T, B, V) float32 log-probs. `arch`: the
    configuration's `dims`, `depths`, `heads`, `local_blocks` and
    `window`."""
    conv = lambda t, w, **kw: F.conv2d(q(t), q(w), **kw)
    x = F.gelu(batch_norm(conv(x, sd["embed_conv1.weight"], stride=2,
                               padding=1), sd, "embed_norm1", False, None))
    x = F.gelu(batch_norm(conv(x, sd["embed_conv2.weight"], stride=2,
                               padding=1), sd, "embed_norm2", False, None))
    B, C, rows, cols = x.shape
    x = x.flatten(2).transpose(1, 2) + sd["pos_embed"]
    i = 0
    for s, (dim, depth, heads) in enumerate(zip(arch["dims"], arch["depths"],
                                                arch["heads"])):
        if s:
            m = f"merges.{s - 1}"
            x = conv(x.transpose(1, 2).reshape(B, -1, rows, cols),
                     sd[f"{m}.conv.weight"], bias=sd[f"{m}.conv.bias"],
                     stride=(2, 1), padding=1)
            rows = x.shape[2]
            x = layer_norm(x.flatten(2).transpose(1, 2), sd, f"{m}.norm",
                           MERGE_EPS)
        mask = window_mask(rows, cols, arch["window"], x.device)
        for b in range(depth):
            kw = dict(sd=sd, name=f"stages.{s}.{b}", heads=heads,
                      mask=mask if i < arch["local_blocks"] else None, q=q)
            if checkpoint:
                x = torch.utils.checkpoint.checkpoint(
                    lambda t, kw=kw: block(t, **kw), x, use_reentrant=False)
            else:
                x = block(x, **kw)
            i += 1
    x = layer_norm(x, sd, "norm", BLOCK_EPS)
    x = x.transpose(1, 2).reshape(B, -1, rows, cols).mean(dim=2,
                                                           keepdim=True)
    x = F.hardswish(conv(x, sd["last_conv.weight"]))         # (B, O, 1, T)
    logits = linear(x.flatten(2).transpose(1, 2), sd, "head", q)
    return torch.log_softmax(logits, dim=-1).transpose(0, 1)
