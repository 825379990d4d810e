"""Port parity: strip extraction (`qea_ocr_tpu_torch/ops/text_stack.py`)
against the JAX package — the XLA gather path and the TPU kernel
`text_stack_pallas` in interpret mode. A strip is a pure copy of document
pixels or white, so every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qea_ocr_tpu.ops.pallas.gather_pallas import text_stack_pallas
from qea_ocr_tpu.ops.text_stack import get_text_stack
from qea_ocr_tpu.ops.text_stack import get_text_stack_batch as jax_batch
from qea_ocr_tpu_torch.ops.cuda import gather_cuda
from qea_ocr_tpu_torch.ops.text_stack import get_text_stack as port_one
from qea_ocr_tpu_torch.ops.text_stack import get_text_stack_batch


def _xla(docs, bboxes):
    return np.asarray(jax.vmap(lambda d, b: get_text_stack(d, b, 32, 128))(
        jnp.asarray(docs), jnp.asarray(bboxes)))


def _port(docs, bboxes):
    return get_text_stack_batch(torch.from_numpy(docs),
                                torch.from_numpy(bboxes)).numpy()


def _boxes(rng, D, S, H, W):
    """Random in-document boxes plus, in the last three slots, the data
    layer's dummy box [0,0,1,1], an empty box and boxes on the borders."""
    b = np.zeros((D, S, 4), np.int32)
    b[..., 0] = rng.integers(0, W - 130, (D, S))
    b[..., 1] = rng.integers(0, H - 34, (D, S))
    b[..., 2] = b[..., 0] + rng.integers(1, 127, (D, S))
    b[..., 3] = b[..., 1] + rng.integers(1, 31, (D, S))
    b[:, -1] = (0, 0, 1, 1)
    b[:, -2] = (0, 0, 0, 0)
    b[0, -3] = (W - 100, H - 20, W, H)
    b[-1, -3] = (0, 0, 127, 31)
    return b


def test_plain_matches_xla_and_pallas_kernel(monkeypatch):
    rng = np.random.default_rng(0)
    D, S, H, W = 3, 7, 48, 384
    docs = rng.random((D, 1, H, W), dtype=np.float32)
    bboxes = _boxes(rng, D, S, H, W)
    got = _port(docs, bboxes)
    assert got.shape == (D, S, 1, 32, 128) and got.dtype == np.float32
    np.testing.assert_array_equal(got, _xla(docs, bboxes))
    np.testing.assert_array_equal(
        got[:, :, 0], np.asarray(text_stack_pallas(jnp.asarray(docs),
                                                   jnp.asarray(bboxes))))
    # and through the JAX dispatcher with the kernel forced on
    monkeypatch.setenv("QEA_GATHER_IMPL", "pallas")
    np.testing.assert_array_equal(
        got, np.asarray(jax_batch(jnp.asarray(docs), jnp.asarray(bboxes))))


def test_dummy_boxes_match_jax():
    docs = np.random.default_rng(1).random((1, 1, 64, 256), dtype=np.float32)
    bboxes = np.array([[[0, 0, 1, 1], [0, 0, 0, 0]]], np.int32)
    got = _port(docs, bboxes)
    np.testing.assert_array_equal(got, _xla(docs, bboxes))
    assert got[0, 1].min() == 1.0                       # empty box: white
    assert got[0, 0, 0, 15, 63] == docs[0, 0, 0, 0]     # 1x1 box, centred
    assert (got[0, 0] == 1.0).sum() == 32 * 128 - 1


@pytest.mark.parametrize("H,W", [(200, 300), (37, 301)])
def test_any_document_size(H, W):
    """No alignment gate: sizes the TPU kernel could not take."""
    rng = np.random.default_rng(H)
    docs = rng.random((2, 1, H, W), dtype=np.float32)
    b = np.zeros((2, 3, 4), np.int32)
    b[..., 0] = rng.integers(0, W - 40, (2, 3))
    b[..., 1] = rng.integers(0, H - 12, (2, 3))
    b[..., 2] = b[..., 0] + rng.integers(1, 40, (2, 3))
    b[..., 3] = b[..., 1] + rng.integers(1, 12, (2, 3))
    np.testing.assert_array_equal(_port(docs, b), _xla(docs, b))


def test_out_of_bounds_boxes_clamp_to_edge_pixels():
    """Pinned: cells of a box that lie outside the document repeat the
    edge pixel (the XLA path's clamping), they are not white."""
    H, W = 64, 256
    docs = np.random.default_rng(2).random((1, 1, H, W), dtype=np.float32)
    bboxes = np.array([[[W - 10, 5, W + 20, 15],      # right edge
                        [-6, -4, 10, 8]]], np.int32)  # top-left corner
    got = _port(docs, bboxes)
    np.testing.assert_array_equal(got, _xla(docs, bboxes))
    tile = got[0, 0, 0]                  # crop 30 wide, 10 high: pad 49, 11
    np.testing.assert_array_equal(tile[11:21, 59:79],
                                  docs[0, 0, 5:15, W - 1:W].repeat(20, 1))
    np.testing.assert_array_equal(tile[11:21, 49:59], docs[0, 0, 5:15, W - 10:])
    corner = got[0, 1, 0]                # crop 16 x 12 from (-6, -4): pad 56, 10
    assert corner[10, 56] == docs[0, 0, 0, 0]


def test_cpu_dispatch_does_not_launch_the_kernel():
    before = gather_cuda.launches
    docs = torch.rand(1, 1, 64, 256)
    out = get_text_stack_batch(docs, torch.zeros(1, 2, 4, dtype=torch.int32))
    assert out.shape == (1, 2, 1, 32, 128)
    assert gather_cuda.launches == before


def test_cuda_wrapper_validates_before_launch():
    docs = torch.rand(1, 1, 64, 256)
    boxes = torch.zeros(1, 2, 4, dtype=torch.int32)
    with pytest.raises(TypeError):
        gather_cuda.text_stack_cuda(docs.double(), boxes)
    with pytest.raises(ValueError):
        gather_cuda.text_stack_cuda(docs[:, 0], boxes)
    with pytest.raises(ValueError):
        gather_cuda.text_stack_cuda(docs, boxes)             # CPU tensors
    # a tensor that requires grad is checked like any other: the wrapper has
    # no quiet detour for it (the gradient is `text_stack`'s kernel pair)
    with pytest.raises(ValueError):
        gather_cuda.text_stack_cuda(docs.requires_grad_(), boxes)
    with pytest.raises(ValueError):
        gather_cuda.text_stack_bwd_cuda(torch.zeros(1, 2, 32, 128), boxes,
                                        (1, 1, 64, 256))     # CPU tensors
    with pytest.raises(ValueError):
        gather_cuda.text_stack_bwd_cuda(torch.zeros(1, 3, 32, 128), boxes,
                                        (1, 1, 64, 256))     # strip mismatch


@pytest.mark.parametrize("shape", [(64, 256), (1, 64, 256)])
def test_one_document_form_matches_jax(shape):
    """`get_text_stack` on one (H, W) or (1, H, W) document with (S, 4)
    boxes, as the CER seed calls it, against the JAX function."""
    rng = np.random.default_rng(3)
    doc = rng.random(shape, dtype=np.float32)
    bboxes = _boxes(rng, 1, 5, 64, 256)[0]
    bboxes[0] = (250, 60, 270, 70)                   # out of the corner
    got = port_one(torch.from_numpy(doc), torch.from_numpy(bboxes)).numpy()
    assert got.shape == (5, 1, 32, 128) and got.dtype == np.float32
    np.testing.assert_array_equal(
        got, np.asarray(get_text_stack(jnp.asarray(doc),
                                       jnp.asarray(bboxes))))
