"""Port parity: the strip gather's gradient with respect to the documents
(`qea_ocr_tpu_torch/ops/text_stack.py`) against `jax.grad` of the JAX
package's `get_text_stack_batch`, on its XLA path and on the TPU kernel
pair `text_stack_pallas` in interpret mode.

Every document pixel's gradient is a sum of the tile-cell gradients read
from it: exact in float32 up to the order of those few additions, hence
abs 1e-6 on gradients of order 1.

The box that pokes out of its document is compared on the XLA path only: the
TPU kernel writes white there (`gather_pallas.py`, "Precondition") where
XLA and the port repeat the edge pixel, whose gradient then collects every
cell that was clamped onto it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qea_ocr_tpu.ops.text_stack import get_text_stack_batch as jax_batch
from qea_ocr_tpu_torch.ops.text_stack import get_text_stack_batch

ATOL = 1e-6


def _boxes(rng, D, S, H, W):
    """Random boxes that overlap freely (S of them in a small document),
    then the data layer's dummy [0,0,1,1], an empty box, and one that
    touches the bottom-right corner."""
    b = np.zeros((D, S, 4), np.int32)
    b[..., 0] = rng.integers(0, W - 40, (D, S))
    b[..., 1] = rng.integers(0, H - 32, (D, S))
    b[..., 2] = b[..., 0] + rng.integers(1, 40, (D, S))
    b[..., 3] = b[..., 1] + rng.integers(1, 31, (D, S))
    b[:, -1] = (0, 0, 1, 1)
    b[:, -2] = (0, 0, 0, 0)
    b[0, -3] = (W - 30, H - 20, W, H)
    return b


def _jax_grad(docs, bboxes, g):
    return np.asarray(jax.grad(lambda d: jnp.sum(
        jax_batch(d, jnp.asarray(bboxes)) * jnp.asarray(g)))(jnp.asarray(docs)))


def _port_grad(docs, bboxes, g):
    d = torch.from_numpy(docs).requires_grad_()
    out = get_text_stack_batch(d, torch.from_numpy(bboxes))
    (out * torch.from_numpy(g)).sum().backward()
    return d.grad.numpy()


def _gather_formulation(bboxes, g, H, W):
    """The backward as `csrc/gather.cu` computes it, in numpy: each document
    pixel loops over its document's boxes in order and adds the tile cells
    the forward filled from it; an edge pixel also takes the cells that the
    forward's clamp moved onto it."""
    D, S = bboxes.shape[:2]
    h_out, w_out = g.shape[-2:]
    far = 1 << 30
    out = np.zeros((D, 1, H, W), np.float32)
    for d in range(D):
        for y in range(H):
            r_lo, r_hi = (-far if y == 0 else y), (far if y == H - 1 else y)
            for x in range(W):
                c_lo, c_hi = (-far if x == 0 else x), (far if x == W - 1 else x)
                total = np.float32(0)
                for s in range(S):
                    x_min, y_min, x_max, y_max = (int(v) for v in bboxes[d, s])
                    row0 = y_min - (h_out - (y_max - y_min)) // 2
                    col0 = x_min - (w_out - (x_max - x_min)) // 2
                    ra = max(r_lo, y_min, row0)
                    rb = min(r_hi, min(y_max, row0 + h_out) - 1)
                    ca = max(c_lo, x_min, col0)
                    cb = min(c_hi, min(x_max, col0 + w_out) - 1)
                    for r in range(ra, rb + 1):
                        for c in range(ca, cb + 1):
                            total += g[d, s, 0, r - row0, c - col0]
                out[d, 0, y, x] = total
    return out


def test_grad_matches_xla_with_overlaps_and_a_box_that_pokes_out(monkeypatch):
    monkeypatch.setenv("QEA_GATHER_IMPL", "xla")
    rng = np.random.default_rng(0)
    D, S, H, W = 2, 7, 64, 64
    docs = rng.random((D, 1, H, W), dtype=np.float32)
    bboxes = _boxes(rng, D, S, H, W)
    bboxes[1, 0] = (W - 10, 5, W + 20, 15)      # pokes out on the right
    bboxes[1, 1] = (-6, -4, 10, 8)              # and over the top-left corner
    g = rng.normal(size=(D, S, 1, 32, 128)).astype(np.float32)
    got = _port_grad(docs, bboxes, g)
    ref = _jax_grad(docs, bboxes, g)
    # the edge pixel of row 5 collects its own cell and the 20 clamped ones
    np.testing.assert_allclose(
        ref[1, 0, 5, W - 1], g[1, 0, 0, 11, 58:79].sum(), atol=1e-5)
    assert np.abs(ref).max() > 1
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_grad_matches_pallas_kernel(monkeypatch):
    """A document size the TPU kernel admits (H % 8 == 0 and >= 40,
    W % 128 == 0 and >= 256), boxes inside the document."""
    monkeypatch.setenv("QEA_GATHER_IMPL", "pallas")
    rng = np.random.default_rng(1)
    D, S, H, W = 2, 6, 48, 256
    docs = rng.random((D, 1, H, W), dtype=np.float32)
    bboxes = _boxes(rng, D, S, H, W)
    g = rng.normal(size=(D, S, 1, 32, 128)).astype(np.float32)
    got = _port_grad(docs, bboxes, g)
    assert np.abs(got).max() > 1
    np.testing.assert_allclose(got, _jax_grad(docs, bboxes, g), atol=ATOL)


def test_gather_formulation_of_the_kernel_equals_autograd():
    """The per-pixel loop the CUDA backward kernel runs (no atomics, fixed
    order) gives what autograd through the plain version gives, clamped edge
    cells and a box larger than the tile included."""
    rng = np.random.default_rng(2)
    D, S, H, W = 1, 6, 40, 24
    docs = rng.random((D, 1, H, W), dtype=np.float32)
    bboxes = np.array([[[2, 3, 20, 30], [5, 10, 22, 25],     # overlapping
                        [W - 6, 5, W + 9, 15],               # pokes out right
                        [-4, -3, 6, 4],                      # top-left corner
                        [3, H - 5, 12, H + 40],              # taller than a tile
                        [0, 0, 0, 0]]], np.int32)
    g = rng.normal(size=(D, S, 1, 32, 128)).astype(np.float32)
    np.testing.assert_allclose(_gather_formulation(bboxes, g, H, W),
                               _port_grad(docs, bboxes, g), atol=1e-5)


def test_no_gradient_reaches_the_boxes_or_a_detached_document():
    docs = torch.rand(1, 1, 64, 64)
    boxes = torch.tensor([[[3, 4, 30, 20]]], dtype=torch.int32)
    out = get_text_stack_batch(docs, boxes)
    assert not out.requires_grad
    with torch.no_grad():
        out = get_text_stack_batch(docs.clone().requires_grad_(), boxes)
    assert not out.requires_grad


def _edge_boxes(H, W):
    """Boxes out of every corner and edge, wholly beyond an edge, larger than
    the kernel's 32 x 128 block tile, overlapping, empty, the data layer's
    dummy and one in the middle (`chip_smoke.py` runs the same set on the
    card)."""
    return np.array([
        (-6, -4, 10, 8), (W - 10, -5, W + 20, 6),
        (-8, H - 6, 12, H + 9), (W - 8, H - 6, W + 12, H + 9),
        (20, -9, 60, 4), (W - 10, 5, W + 20, 15),
        (30, H - 3, 90, H + 20), (-15, 12, 6, 20),
        (W + 3, 10, W + 30, 20), (5, -40, 50, -25),
        (5, 5, 305, 65),
        (10, 10, 30, 25), (12, 12, 32, 27),
        (0, 0, 0, 0), (0, 0, 1, 1),
        (W // 2 - 20, H // 2 - 8, W // 2 + 20, H // 2 + 8)], np.int32)


def _tile_culled(bboxes, g, H, W, rows=4, cols=128):
    """The backward as `csrc/gather.cu` tiles it, in numpy: each warp's
    `rows` x `cols` pixels keep only the boxes whose source range meets
    theirs, opened to +-infinity at the document's edges; each pixel then
    walks those boxes in strip order. Also returns how many boxes each
    sub-tile kept."""
    D, S = bboxes.shape[:2]
    h_out, w_out = g.shape[-2:]
    far = 1 << 30
    out = np.zeros((D, 1, H, W), np.float32)
    kept = []
    for d in range(D):
        src = []
        for x_min, y_min, x_max, y_max in (map(int, b) for b in bboxes[d]):
            row0 = y_min - (h_out - (y_max - y_min)) // 2
            col0 = x_min - (w_out - (x_max - x_min)) // 2
            src.append((max(y_min, row0), min(y_max, row0 + h_out) - 1,
                        max(x_min, col0), min(x_max, col0 + w_out) - 1,
                        row0, col0))
        for y0 in range(0, H, rows):
            y1 = min(y0 + rows, H) - 1
            wr = (-far if y0 == 0 else y0, far if y1 == H - 1 else y1)
            for x0 in range(0, W, cols):
                x1 = min(x0 + cols, W) - 1
                wc = (-far if x0 == 0 else x0, far if x1 == W - 1 else x1)
                live = [(s, b) for s, b in enumerate(src)
                        if b[0] <= b[1] and b[2] <= b[3] and b[0] <= wr[1]
                        and b[1] >= wr[0] and b[2] <= wc[1]
                        and b[3] >= wc[0]]
                kept.append(len(live))
                for y in range(y0, y1 + 1):
                    for x in range(x0, x1 + 1):
                        total = np.float32(0)
                        for s, (ra, rb, ca, cb, row0, col0) in live:
                            r_a = max(-far if y == 0 else y, ra)
                            r_b = min(far if y == H - 1 else y, rb)
                            c_a = max(-far if x == 0 else x, ca)
                            c_b = min(far if x == W - 1 else x, cb)
                            for r in range(r_a, r_b + 1):
                                for c in range(c_a, c_b + 1):
                                    total += g[d, s, 0, r - row0, c - col0]
                        out[d, 0, y, x] = total
    return out, kept


@pytest.mark.parametrize("H,W", [(37, 70), (33, 129), (45, 131)])
def test_tile_culled_formulation_of_the_kernel_equals_autograd(H, W):
    """The tiled, culled loop the CUDA backward kernel runs gives what
    autograd through the plain version gives, on documents that are
    multiples of neither the tile nor (in W) of 4, with boxes out of every
    edge and corner; every sub-tile culls some of the boxes."""
    rng = np.random.default_rng(H * W)
    boxes = _edge_boxes(H, W)
    bboxes = np.stack([boxes, boxes[::-1]])
    D, S = bboxes.shape[:2]
    docs = rng.random((D, 1, H, W), dtype=np.float32)
    g = rng.normal(size=(D, S, 1, 32, 128)).astype(np.float32)
    got, kept = _tile_culled(bboxes, g, H, W)
    np.testing.assert_allclose(got, _port_grad(docs, bboxes, g), atol=1e-5)
    assert max(kept) < S
