"""SVTR's shapes from a configuration, and its weights made from the seed
(`weights.make_state`, the same draw as the other models'), in the
state_dict schema of the program's `models/svtr.py`, which the plain
reference (`reference/svtr.py`) reads too.

The configuration keeps PaddleOCR's own keys for SVTRNet: `embed_dim`,
`depth`, `num_heads`, `mixer` (the blocks' kinds in order, "Local" ones
first), `local_mixer` (the window), `mlp_ratio`, `out_channels`.

Scales, leaf by leaf: convs He-normal over fan-in; linear weights
N(0, 1 / fan_in), so that a LayerNorm'd token gives unit-scale q and k and
attention logits of unit scale (a softmax that is neither flat nor one
spike); biases and the position table N(0, 1e-4); LayerNorm and batch norm
weight 1, bias 0, running mean 0, variance 1.
"""

from __future__ import annotations


def arch(cfg: dict) -> dict:
    """The reference's and the program's arguments from the configuration."""
    mixer = cfg["mixer"]
    local = mixer.count("Local")
    if mixer != ["Local"] * local + ["Global"] * (len(mixer) - local) \
            or len(mixer) != sum(cfg["depth"]):
        raise ValueError(f"mixer {mixer} is not Local blocks then Global "
                         f"ones over {sum(cfg['depth'])} blocks")
    return dict(dims=tuple(cfg["embed_dim"]), depths=tuple(cfg["depth"]),
                heads=tuple(cfg["num_heads"]), local_blocks=local,
                window=tuple(cfg["local_mixer"]),
                mlp_ratio=cfg["mlp_ratio"],
                out_channels=cfg["out_channels"])


def _norm(prefix: str, c: int, running: bool = False):
    out = [(f"{prefix}.weight", (c,), "one"), (f"{prefix}.bias", (c,), "zero")]
    if running:
        out += [(f"{prefix}.running_mean", (c,), "zero"),
                (f"{prefix}.running_var", (c,), "one"),
                (f"{prefix}.num_batches_tracked", (), "count")]
    return out


def svtr_schema(a: dict, vocab: int, grid=(8, 32)):
    """[(name, shape, kind)] of SVTR's state_dict for `arch(cfg)`."""
    d0 = a["dims"][0]
    out = [("embed_conv1.weight", (d0 // 2, 1, 3, 3), "w"),
           *_norm("embed_norm1", d0 // 2, True),
           ("embed_conv2.weight", (d0, d0 // 2, 3, 3), "w"),
           *_norm("embed_norm2", d0, True),
           ("pos_embed", (1, grid[0] * grid[1], d0), "b")]
    for s, (d, depth) in enumerate(zip(a["dims"], a["depths"])):
        hidden = a["mlp_ratio"] * d
        for b in range(depth):
            p = f"stages.{s}.{b}"
            out += [*_norm(f"{p}.norm1", d),
                    (f"{p}.mixer.qkv.weight", (3 * d, d), "lw"),
                    (f"{p}.mixer.qkv.bias", (3 * d,), "b"),
                    (f"{p}.mixer.proj.weight", (d, d), "lw"),
                    (f"{p}.mixer.proj.bias", (d,), "b"),
                    *_norm(f"{p}.norm2", d),
                    (f"{p}.fc1.weight", (hidden, d), "lw"),
                    (f"{p}.fc1.bias", (hidden,), "b"),
                    (f"{p}.fc2.weight", (d, hidden), "lw"),
                    (f"{p}.fc2.bias", (d,), "b")]
    for k in (0, 1):
        cin, cout = a["dims"][k], a["dims"][k + 1]
        out += [(f"merges.{k}.conv.weight", (cout, cin, 3, 3), "w"),
                (f"merges.{k}.conv.bias", (cout,), "b"),
                *_norm(f"merges.{k}.norm", cout)]
    out += [*_norm("norm", a["dims"][2]),
            ("last_conv.weight", (a["out_channels"], a["dims"][2], 1, 1),
             "w"),
            ("head.weight", (vocab, a["out_channels"]), "lw"),
            ("head.bias", (vocab,), "b")]
    return out
