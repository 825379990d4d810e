"""The benchmark's own operation and byte counts, and the card's peaks.

Model FLOPs are counted from the published shapes: convolutions,
transposed convolutions and matmuls only, 2 per multiply-add, whatever
implements them. A layer's backward costs one forward for the gradient of
its weights (when they are trained) and one for the gradient of its input
(when anything before it needs one).

A hand-written kernel's least time is the larger of the bytes it must move
over the memory rate and its operations over their peak: a frozen copy of
`chip_smoke.py`'s bound arithmetic. The CTC count follows what the inputs
need: alpha only below each row's extended length 2 len + 1.

Peaks: NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s bfloat16 on the
tensor cores, 67 TFLOP/s float32 outside them, 3.35 TB/s of HBM. The card's
power limit is printed beside every share.
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(n_bytes: float, n_flops: float, peak: float = PEAK_F32) -> float:
    """The least time (s) the card could take."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / peak)


# ---------------------------------------------------------------- model FLOPs
def unet_layers(f: int, H: int, W: int, cin: int = 1, cout: int = 1):
    """[(name, forward FLOPs of one image)] of the UNet in execution order."""
    out = []
    chans = [(cin, f), (f, 2 * f), (2 * f, 4 * f), (4 * f, 8 * f),
             (8 * f, 16 * f)]
    names = ("enc1", "enc2", "enc3", "enc4", "bottleneck")
    for lvl, ((ci, co), name) in enumerate(zip(chans, names)):
        px = (H >> lvl) * (W >> lvl)
        out.append((f"{name}.1", 2 * 9 * ci * co * px))
        out.append((f"{name}.2", 2 * 9 * co * co * px))
    for lvl in (4, 3, 2, 1):
        co = f << (lvl - 1)
        px = (H >> (lvl - 1)) * (W >> (lvl - 1))
        # transposed 2x2 stride 2: one tap an output pixel
        out.append((f"upconv{lvl}", 2 * (2 * co) * co * px))
        out.append((f"dec{lvl}.1", 2 * 9 * (2 * co) * co * px))
        out.append((f"dec{lvl}.2", 2 * 9 * co * co * px))
    out.append(("conv", 2 * f * cout * H * W))
    return out


def crnn_layers(features, hidden: int, layers: int, vocab: int,
                h: int = 32, w: int = 128):
    """[(name, forward FLOPs of one strip)] of the CRNN."""
    pools = {1: (2, 2), 2: (2, 2), 4: (2, 1), 6: (2, 1)}
    out, cin = [], 1
    for j, c in enumerate(features[:6], start=1):
        out.append((f"conv{j}", 2 * 9 * cin * c * h * w))
        cin = c
        if j in pools:
            h, w = h // pools[j][0], w // pools[j][1]
    T = w - 1
    out.append(("conv7", 2 * 4 * cin * features[6] * (h - 1) * T))
    c = features[6] * (h - 1)
    for k in range(layers):
        out.append((f"lstm{k}.ih", 2 * 2 * T * c * 4 * hidden))
        out.append((f"lstm{k}.hh", 2 * 2 * T * hidden * 4 * hidden))
        c = 2 * hidden
    out.append(("linear", 2 * T * c * vocab))
    return out


def train_flops(layers, n: int, weights: bool, input_grad: bool) -> float:
    """Forward and backward FLOPs of `layers` on `n` inputs: the forward;
    each layer's weight gradient when `weights`; each layer's input gradient
    when `input_grad` (the data's own gradient is needed at the first layer)
    or when any layer before it takes a weight gradient."""
    total = 0.0
    for i, (_, fl) in enumerate(layers):
        total += fl
        if weights:
            total += fl
        if input_grad or (weights and i > 0):
            total += fl
    return n * total


def patch_step_flops(cfg: dict, docs: int, jitter_copies: int) -> float:
    """One patch-trainer step: `prep_extract` (UNet eval on the documents),
    phase A (the CRNN trained on the history strips and each jitter copy:
    (1 + copies) x N rows) and phase B (the UNet trained through the strip
    gather and the CRNN, whose weights are not updated: its input gradient
    only)."""
    u = unet_layers(cfg["unet_features"], *cfg["doc_size"])
    c = crnn_layers(cfg["conv_features"], cfg["lstm_hidden"],
                    cfg["lstm_layers"], cfg["vocab_size"], *cfg["strip_size"])
    N = docs * cfg["strip_slots"]
    return (train_flops(u, docs, False, False)
            + train_flops(c, (1 + jitter_copies) * N, True, False)
            + train_flops(u, docs, True, False)
            + train_flops(c, N, False, True))


def area_step_flops(cfg: dict, crops: int, jitter_copies: int) -> float:
    """One area step: the UNet's eval forward on the crops, phase A as in
    the patch step on (1 + copies) x B rows, phase B (UNet trained through
    the CRNN's input gradient)."""
    h, w = cfg["strip_size"]
    u = unet_layers(cfg["unet_features"], h, w)
    c = crnn_layers(cfg["conv_features"], cfg["lstm_hidden"],
                    cfg["lstm_layers"], cfg["vocab_size"], h, w)
    return (train_flops(u, crops, False, False)
            + train_flops(c, (1 + jitter_copies) * crops, True, False)
            + train_flops(u, crops, True, False)
            + train_flops(c, crops, False, True))


def unet_forward_flops(cfg: dict, n: int) -> float:
    return n * sum(fl for _, fl in unet_layers(cfg["unet_features"],
                                               *cfg["doc_size"]))


# ------------------------------------------------------------ kernel bounds
def ctc_pair_bound_s(T: int, V: int, L: int, lengths) -> float:
    """Least time of the CTC forward with alpha plus its backward on rows
    of these label lengths (all feasible): log-probs, labels, lengths in,
    NLL out, the alpha the backward reads; the backward reads alpha and the
    emissions below each row's extended length, the upstream gradient, and
    writes d log_probs. Operations: 12 a cell forward, 16 backward."""
    B = len(lengths)
    cells = T * sum(2 * min(max(int(n), 0), L) + 1 for n in lengths)
    lp = 4 * T * B * V
    io = lp + 4 * B * L + 4 * B + 4 * B
    fwd = bound_s(io + 4 * cells, 12 * cells)
    bwd = bound_s(4 * B * L + 4 * B + 4 * B + 4 * B + lp + 8 * cells,
                  16 * cells)
    return fwd + bwd


def gather_fwd_bound_s(D: int, S: int, box_area: int, h: int = 32,
                       w: int = 128) -> float:
    """Tile cells written once, the pixels under the boxes read once, the
    boxes."""
    return bound_s(4 * (D * S * h * w + box_area) + 16 * D * S, 0)


def gather_bwd_bound_s(D: int, S: int, box_area: int, H: int,
                       W: int) -> float:
    """The tile gradients under the boxes read, every document pixel
    written once, the boxes; one add a box pixel."""
    return bound_s(4 * (box_area + D * H * W) + 16 * D * S, box_area)


def conv_cmajor_bound_s(d: int, cin: int, cout: int, h: int, w: int) -> float:
    """Image rows read once (bfloat16), the output with its halo rows
    written once, weights and shift; one multiply-add a tap, input and
    output channel and pixel, at the bfloat16 peak."""
    n_bytes = 2 * d * cin * h * w + 2 * d * cout * (h + 2) * w \
        + 2 * 9 * cin * cout + 4 * cout
    return bound_s(n_bytes, 2 * 9 * cin * cout * d * h * w, PEAK_BF16)


def unet_cmajor_convs(f: int, H: int, W: int):
    """(Cin, Cout, h, w) of the eight convs the channel-major route sends to
    the kernel in one UNet forward: levels 1 and 2 of the encoder and the
    decoder."""
    return [(1, f, H, W), (f, f, H, W), (f, 2 * f, H // 2, W // 2),
            (2 * f, 2 * f, H // 2, W // 2), (4 * f, 2 * f, H // 2, W // 2),
            (2 * f, 2 * f, H // 2, W // 2), (2 * f, f, H, W), (f, f, H, W)]
