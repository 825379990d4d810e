"""The plain reference of the two models: float32 PyTorch, written from the
published architecture (tataganesh/Query-Efficient-Approx-to-improve-OCR,
arXiv:2306.13236) and the compute policy the configuration states, over a
dict of tensors in the reference schema (`portbench/weights.py`).

UNet: four levels of (conv3x3 without bias -> batch norm -> ReLU) x 2 from
`f` features doubling each level, 2x2 max pools, a bottleneck, stride-2
transposed convs with skip concatenations, a 1x1 conv and a sigmoid.
CRNN: seven convs (pools 2x2, 2x2, 2x1, 2x1; batch norm after conv5 and
conv6; a valid 2x2 conv7), then a 2-layer bidirectional LSTM (gates i, f,
g, o; one bias a gate, the input-side bias a fixed buffer), a linear layer
and a log-softmax, time-major (T, B, V).

Batch norm in train mode normalises with the batch's mean and biased
variance and moves the running statistics by `new = 0.9 old + 0.1 batch`
(biased variance); in eval mode it uses the running statistics.

Every conv and matmul reads its operands through `q`, the identity for the
reference. The control passes a rounding to a lower precision
(`reference/precision.py`) and so runs the same arithmetic with rounded
operands. Nothing here imports the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench.weights import UNET_BLOCKS

EPS = 1e-5
MOMENTUM = 0.1


def _ident(x):
    return x


def batch_norm(x, sd, prefix, train: bool, stats: list | None):
    """Batch norm over the channels of x (B, C, ...). In train mode the
    batch's (mean, biased variance) are appended to `stats` for the caller
    to fold into the running statistics once (`fold_running`)."""
    w, b = sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if train:
        dims = [0, *range(2, x.dim())]
        mean = x.mean(dim=dims)
        var = ((x - mean.reshape(shape)) ** 2).mean(dim=dims)
        if stats is not None:
            stats.append((prefix, mean.detach(), var.detach()))
    else:
        mean, var = sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"]
    return ((x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + EPS)
            * w.reshape(shape) + b.reshape(shape))


def fold_running(sd, stats) -> None:
    """Move the running statistics by the batches' statistics, in place."""
    with torch.no_grad():
        for prefix, mean, var in stats:
            rm, rv = sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"]
            rm.mul_(1 - MOMENTUM).add_(mean, alpha=MOMENTUM)
            rv.mul_(1 - MOMENTUM).add_(var, alpha=MOMENTUM)


def conv2d(x, w, b=None, q=_ident, **kw):
    return F.conv2d(q(x), q(w), b, **kw)


def unet_block(x, sd, module, prefix, train, stats, q=_ident):
    for j in (1, 2):
        x = conv2d(x, sd[f"{module}.{prefix}conv{j}.weight"], padding=1, q=q)
        x = F.relu(batch_norm(x, sd, f"{module}.{prefix}norm{j}", train,
                              stats))
    return x


def upconv(x, sd, lvl, q=_ident):
    return F.conv_transpose2d(q(x), q(sd[f"upconv{lvl}.weight"]),
                              sd[f"upconv{lvl}.bias"], stride=2)


def unet(x, sd, train: bool = False, stats: list | None = None, q=_ident,
         checkpoint: bool = False):
    """(B, 1, H, W) float -> (B, 1, H, W) sigmoid output. With `checkpoint`
    each block is recomputed in the backward instead of kept (the same
    numbers, less memory)."""
    names = {m: p for m, p, _, _ in UNET_BLOCKS}

    def block(module, inp):
        if not checkpoint:
            return unet_block(inp, sd, module, names[module], train, stats, q)
        local: list = []
        y = torch.utils.checkpoint.checkpoint(
            lambda t: unet_block(t, sd, module, names[module], train, local,
                                 q),
            inp, use_reentrant=False)
        if stats is not None:
            # the first forward's statistics; a recomputation appends again
            stats.extend(local[:2])
        return y

    enc1 = block("encoder1", x)
    enc2 = block("encoder2", F.max_pool2d(enc1, 2))
    enc3 = block("encoder3", F.max_pool2d(enc2, 2))
    enc4 = block("encoder4", F.max_pool2d(enc3, 2))
    bott = block("bottleneck", F.max_pool2d(enc4, 2))
    dec4 = block("decoder4", torch.cat([upconv(bott, sd, 4, q), enc4], 1))
    dec3 = block("decoder3", torch.cat([upconv(dec4, sd, 3, q), enc3], 1))
    dec2 = block("decoder2", torch.cat([upconv(dec3, sd, 2, q), enc2], 1))
    dec1 = block("decoder1", torch.cat([upconv(dec2, sd, 1, q), enc1], 1))
    return torch.sigmoid(conv2d(dec1, sd["conv.weight"], sd["conv.bias"],
                                q=q))


def crnn(x, sd, hidden: int, layers: int, q=_ident):
    """(B, 1, 32, 128) strips -> (T, B, V) float32 log-probs; batch norm
    with its running statistics (the trainers freeze the CRNN's)."""
    c = lambda t, j, **kw: conv2d(t, sd[f"convo.conv{j}.weight"],
                                  sd[f"convo.conv{j}.bias"], q=q, **kw)
    x = F.max_pool2d(F.relu(c(x, 1, padding=1)), (2, 2))
    x = F.max_pool2d(F.relu(c(x, 2, padding=1)), (2, 2))
    x = F.relu(c(x, 3, padding=1))
    x = F.max_pool2d(F.relu(c(x, 4, padding=1)), (2, 1))
    x = F.relu(batch_norm(c(x, 5, padding=1), sd, "convo.batchnorm1", False,
                          None))
    x = F.relu(batch_norm(c(x, 6, padding=1), sd, "convo.batchnorm2", False,
                          None))
    x = c(F.max_pool2d(x, (2, 1)), 7)                     # (B, C, 1, T)
    B, C, Hf, T = x.shape
    seq = x.permute(0, 3, 2, 1).reshape(B, T, Hf * C)
    for k in range(layers):
        seq = torch.cat([_lstm_dir(seq, sd, f"l{k}", hidden, False, q),
                         _lstm_dir(seq, sd, f"l{k}_reverse", hidden, True, q)],
                        dim=-1)
    logits = F.linear(q(seq), q(sd["linear.weight"]), sd["linear.bias"])
    return torch.log_softmax(logits, dim=-1).transpose(0, 1)


def _lstm_dir(seq, sd, sfx, hidden, reverse, q):
    B, T, _ = seq.shape
    w_ih, w_hh = sd[f"lstm.weight_ih_{sfx}"], sd[f"lstm.weight_hh_{sfx}"]
    bias = sd[f"lstm.bias_ih_{sfx}"] + sd[f"lstm.bias_hh_{sfx}"]
    xw = F.linear(q(seq), q(w_ih)) + bias                   # (B, T, 4H)
    h = seq.new_zeros(B, hidden)
    c = seq.new_zeros(B, hidden)
    outs = [None] * T
    order = range(T - 1, -1, -1) if reverse else range(T)
    for t in order:
        gates = xw[:, t] + F.linear(q(h), q(w_hh))
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs[t] = h
    return torch.stack(outs, dim=1)
