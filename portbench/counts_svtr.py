"""SVTR's model FLOPs and the least time of its attention, counted from the
published shapes (`weights_svtr.arch`), as `counts.py` counts the other
models: convs and matmuls only, 2 per multiply-add, whatever implements
them.

Attention counts the work the equations need: a query is paired with the
keys of its clipped window in a local block and with every key in a global
one (`window_pairs`), whatever a masked dense kernel computes beside. Per
head, the forward's two products take 4 x pairs x 32 operations, the
backward's four 8 x pairs x 32; whenever any gradient passes through them
the backward runs all four (both operands are activations).
"""

from __future__ import annotations

from portbench import counts
from portbench.weights_svtr import arch

HEAD_DIM = 32
BF16_BYTES = 2


def window_pairs(rows: int, cols: int, window) -> int:
    """(query, key) pairs inside the clipped windows of a rows x cols
    grid."""
    def along(n, half):
        return sum(min(n - 1, i + half) - max(0, i - half) + 1
                   for i in range(n))
    return along(rows, window[0] // 2) * along(cols, window[1] // 2)


def blocks(a: dict, grid=(8, 32)):
    """[(kind, dim, heads, tokens, pairs)] of every block in order."""
    out, i = [], 0
    rows, cols = grid
    for s, (d, depth, h) in enumerate(zip(a["dims"], a["depths"],
                                          a["heads"])):
        if s:
            rows //= 2
        n = rows * cols
        for _ in range(depth):
            local = i < a["local_blocks"]
            pairs = window_pairs(rows, cols, a["window"]) if local else n * n
            out.append(("local" if local else "global", d, h, n, pairs))
            i += 1
    return out


def layers(a: dict, vocab: int, grid=(8, 32)):
    """[(name, forward FLOPs of one crop, weighted)] in execution order;
    `weighted` is False for attention's two products, whose backward does
    not depend on the weights' gradient being wanted."""
    d0 = a["dims"][0]
    rows, cols = grid
    out = [("embed1", 2 * 9 * 1 * (d0 // 2) * (2 * rows) * (2 * cols), True),
           ("embed2", 2 * 9 * (d0 // 2) * d0 * rows * cols, True)]
    prev = d0
    for k, (kind, d, h, n, pairs) in enumerate(blocks(a, grid)):
        if k and n != prev_n:
            out.append((f"merge{k}", 2 * 9 * prev * d * n, True))
        prev, prev_n = d, n
        hidden = a["mlp_ratio"] * d
        out += [(f"b{k}.qkv", 2 * n * d * 3 * d, True),
                (f"b{k}.attn", 4 * h * pairs * HEAD_DIM, False),
                (f"b{k}.proj", 2 * n * d * d, True),
                (f"b{k}.mlp", 2 * 2 * n * d * hidden, True)]
    T = cols
    out += [("last_conv", 2 * a["dims"][-1] * a["out_channels"] * T, True),
            ("head", 2 * a["out_channels"] * vocab * T, True)]
    return out


def train_flops(ls, n: int, weights: bool, input_grad: bool) -> float:
    """`counts.train_flops` for SVTR's layers: attention's backward costs
    two forwards wherever a gradient passes it (every layer after the first
    takes one when `weights`, and every layer when `input_grad`)."""
    total = 0.0
    for i, (_, fl, weighted) in enumerate(ls):
        total += fl
        passes = input_grad or (weights and i > 0)
        if weighted:
            total += (fl if weights else 0.0) + (fl if passes else 0.0)
        elif passes:
            total += 2 * fl
    return n * total


def area_step_flops(cfg: dict, crops: int, jitter_copies: int) -> float:
    """One area step with SVTR as the proxy: the UNet's eval forward, phase
    A on (1 + copies) x B rows, phase B (the UNet trained through SVTR's
    input gradient)."""
    h, w = cfg["strip_size"]
    u = counts.unet_layers(cfg["unet_features"], h, w)
    s = layers(arch(cfg), cfg["vocab_size"], (h // 4, w // 4))
    return (counts.train_flops(u, crops, False, False)
            + train_flops(s, (1 + jitter_copies) * crops, True, False)
            + counts.train_flops(u, crops, True, False)
            + train_flops(s, crops, False, True))


def attention_bound_s(a: dict, rows: int, grid=(8, 32)) -> float:
    """Least time of the attention of `rows` crops, forward and backward,
    at the bfloat16 peak: per block and head the forward's 4 x pairs x 32
    operations and q, k, v, o read or written once; the backward's
    8 x pairs x 32 and q, k, v, o, dO, dq, dk, dv once."""
    total = 0.0
    for _, d, h, n, pairs in blocks(a, grid):
        tensor = BF16_BYTES * rows * h * n * HEAD_DIM
        fl = rows * h * pairs * HEAD_DIM
        total += counts.bound_s(4 * tensor, 4 * fl, counts.PEAK_BF16)
        total += counts.bound_s(8 * tensor, 8 * fl, counts.PEAK_BF16)
    return total
