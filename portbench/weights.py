"""The models' weights, made by the benchmark from the seed.

The names are the reference schema's (the state_dict of the published
PyTorch models, which the port keeps), so one dict loads into the program
(`load_state_dict(strict=True)`) and into the plain reference alike. The
values come from one standard-normal draw on the device per model, in the
type they are served in (float32 parameters), scaled leaf by leaf:

  conv and linear weights   N(0, 2 / fan_in) (He), so activations keep
                            their scale through the ReLU ladders
  LSTM weights              N(0, 1 / fan_in)
  conv, linear, LSTM biases N(0, 1e-4)
  batch norm                weight 1, bias 0, running mean 0, variance 1

A random network of default (uniform +-1/sqrt(fan_in)) weights shrinks its
activations level by level until the UNet's output is one grey; these keep
every layer's arithmetic in the comparison.
"""

from __future__ import annotations

import math

import torch

UNET_BLOCKS = (("encoder1", "enc1", 0, 1), ("encoder2", "enc2", 1, 2),
               ("encoder3", "enc3", 2, 4), ("encoder4", "enc4", 4, 8),
               ("bottleneck", "bottleneck", 8, 16),
               ("decoder4", "dec4", 16, 8), ("decoder3", "dec3", 8, 4),
               ("decoder2", "dec2", 4, 2), ("decoder1", "dec1", 2, 1))


def unet_schema(f: int, in_channels: int = 1, out_channels: int = 1):
    """[(name, shape, kind)] of the UNet's state_dict. A block's input
    channels are `cin_mult * f` (the first block takes the image's)."""
    out = []
    for module, prefix, cin_mult, cout_mult in UNET_BLOCKS:
        cin = in_channels if cin_mult == 0 else cin_mult * f
        cout = cout_mult * f
        for j, c in ((1, cin), (2, cout)):
            out.append((f"{module}.{prefix}conv{j}.weight", (cout, c, 3, 3),
                        "w"))
            out.extend(_bn(f"{module}.{prefix}norm{j}", cout))
    for lvl, (cin, cout) in zip((4, 3, 2, 1), ((16, 8), (8, 4), (4, 2),
                                                 (2, 1))):
        out.append((f"upconv{lvl}.weight", (cin * f, cout * f, 2, 2), "wt"))
        out.append((f"upconv{lvl}.bias", (cout * f,), "b"))
    out.append(("conv.weight", (out_channels, f, 1, 1), "w"))
    out.append(("conv.bias", (out_channels,), "b"))
    return out


def crnn_schema(features, hidden: int, layers: int, vocab: int):
    out = []
    cin = 1
    for j, f in enumerate(features[:6], start=1):
        out.append((f"convo.conv{j}.weight", (f, cin, 3, 3), "w"))
        out.append((f"convo.conv{j}.bias", (f,), "b"))
        cin = f
    out.append(("convo.conv7.weight", (features[6], cin, 2, 2), "w"))
    out.append(("convo.conv7.bias", (features[6],), "b"))
    out.extend(_bn("convo.batchnorm1", features[4]))
    out.extend(_bn("convo.batchnorm2", features[5]))
    for k in range(layers):
        c = features[6] if k == 0 else 2 * hidden
        for sfx in (f"l{k}", f"l{k}_reverse"):
            out.append((f"lstm.weight_ih_{sfx}", (4 * hidden, c), "lw"))
            out.append((f"lstm.weight_hh_{sfx}", (4 * hidden, hidden), "lw"))
            out.append((f"lstm.bias_ih_{sfx}", (4 * hidden,), "zero"))
            out.append((f"lstm.bias_hh_{sfx}", (4 * hidden,), "b"))
    out.append(("linear.weight", (vocab, 2 * hidden), "w"))
    out.append(("linear.bias", (vocab,), "b"))
    return out


def _bn(prefix: str, c: int):
    return [(f"{prefix}.weight", (c,), "one"), (f"{prefix}.bias", (c,), "zero"),
            (f"{prefix}.running_mean", (c,), "zero"),
            (f"{prefix}.running_var", (c,), "one"),
            (f"{prefix}.num_batches_tracked", (), "count")]


def _fan_in(shape) -> int:
    return math.prod(shape[1:])


def make_state(schema, seed: int, salt: int,
               device: torch.device) -> dict[str, torch.Tensor]:
    """The state_dict for `schema` from `seed`: one normal draw on `device`
    from a generator of its own (`salt` tells the models apart)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + salt) % (2 ** 63))
    sizes = [math.prod(s) for _, s, k in schema]
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, kind), n in zip(schema, sizes):
        x = flat[at:at + n].reshape(shape)
        at += n
        if kind == "w":
            x = x * math.sqrt(2.0 / _fan_in(shape))
        elif kind == "wt":
            x = x * math.sqrt(2.0 / shape[0])
        elif kind == "lw":
            x = x * math.sqrt(1.0 / shape[1])
        elif kind == "b":
            x = x * 1e-2
        elif kind == "one":
            x = torch.ones(shape, device=device)
        elif kind == "zero":
            x = torch.zeros(shape, device=device)
        elif kind == "count":
            x = torch.zeros(shape, dtype=torch.long, device=device)
        out[name] = x.contiguous()
    return out


def parameter_names(schema) -> list[str]:
    """The leaves an optimizer moves, in schema order: every weight and
    bias, batch norm's scale and shift; not the running statistics, the
    step count or the LSTM's input-side bias."""
    return [name for name, _, kind in schema
            if kind in ("w", "wt", "lw", "b")
            or (kind in ("one", "zero") and name.rsplit(".", 1)[1] in
                ("weight", "bias") and "bias_ih" not in name)]
