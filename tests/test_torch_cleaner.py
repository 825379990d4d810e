"""The serving cleaner's canvases (`serve/cleaner.py`): the uint8 batch the
UNet receives equals, byte for byte, white float canvases quantised on the
host by `np.round(stack * 255).clip(0, 255).astype(np.uint8)`, the formula
the cleaner used before it moved the quantisation onto the device; and on
a card, `clean_dir`'s pipelined batches equal `clean_arrays_uint8`'s.

The card test skips without a CUDA device. On the card (where JAX is not
installed, so the repository's conftest is left out):
`python -m pytest --noconftest tests/test_torch_cleaner.py`."""

import os
import zlib

import numpy as np
import pytest
import torch

from qea_ocr_tpu_torch.data.datasets import find_images, load_gray
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.serve.cleaner import DocumentCleaner, save_png

torch.set_num_threads(1)
DOC = (32, 64)


def _host_canvases(docs, size, h, w):
    """The former host path: each document centred on a white float32
    canvas (shrunk by Pillow when larger), the stack quantised to uint8,
    white rows to `size`."""
    from PIL import Image
    canvases = []
    for img in docs:
        img = np.asarray(img, np.float32)
        ih, iw = img.shape
        if ih > h or iw > w:
            pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
            pil.thumbnail((w, h))
            img = np.asarray(pil, np.float32) / 255.0
            ih, iw = img.shape
        top, left = (h - ih) // 2, (w - iw) // 2
        out = np.ones((h, w), np.float32)
        out[top:top + ih, left:left + iw] = img
        canvases.append(out)
    arr = np.full((size, 1, h, w), 255, np.uint8)
    if canvases:
        arr[:len(canvases)] = np.round(np.stack(canvases)[:, None] * 255.0
                                       ).clip(0, 255).astype(np.uint8)
    return arr


def _half_steps(rng, shape):
    """(k + 0.5) / 255 and one float32 ulp either side, for random k."""
    k = rng.integers(0, 255, shape)
    x = ((k + 0.5) / 255.0).astype(np.float32)
    side = rng.integers(-1, 2, shape)
    return np.where(side < 0, np.nextafter(x, np.float32(-1)),
                    np.where(side > 0, np.nextafter(x, np.float32(2)), x)
                    ).astype(np.float32)


def _bounds(rng, shape):
    """0, 1, below 0 and above 1, and a few ordinary values."""
    pool = np.asarray([0.0, 1.0, -0.001, -3.0, 1.001, 7.5, 0.25, 0.999],
                      np.float32)
    return pool[rng.integers(0, len(pool), shape)]


def _docs(case, rng):
    """The case's documents and batch size (one batch or more)."""
    h, w = DOC
    if case == "half steps":
        return [_half_steps(rng, s) for s in ((20, 30), (31, 63), (7, 64))], 4
    if case == "bounds":
        return [_bounds(rng, s) for s in ((32, 10), (5, 5))], 2
    if case == "the canvas's size":
        return [rng.random(DOC, dtype=np.float32),
                _half_steps(rng, DOC)], 2
    if case == "larger than the canvas":
        return [rng.random((2 * h + 3, w + 9), dtype=np.float32),
                rng.random((h + 1, 3 * w), dtype=np.float32),
                rng.random((9, 9), dtype=np.float32)], 3
    if case == "a short tail batch":
        return [rng.random((10 + i, 40 - i), dtype=np.float32)
                for i in range(5)], 2
    raise ValueError(case)


def _spy(monkeypatch):
    """Record every uint8 batch `DocumentCleaner._forward` receives (a copy
    on its device: reading it back here would wait for the device)."""
    seen = []
    forward = DocumentCleaner._forward

    def spy(self, images):
        seen.append(images.clone())
        return forward(self, images)
    monkeypatch.setattr(DocumentCleaner, "_forward", spy)
    return seen


def _cleaner(batch_size, device="cpu", features=4, doc=DOC):
    sd = UNet(init_features=features).state_dict()
    return DocumentCleaner(state_dict=sd, device=device,
                           batch_size=batch_size, doc_size=doc,
                           unet_features=features)


def _write_pngs(root, rng, n, h, w):
    """`n` grey documents of random sizes (some larger than the canvas)
    as PNG files under `root`; the sorted paths."""
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        shape = (int(rng.integers(h // 3, h + h // 4)),
                 int(rng.integers(w // 3, w + w // 4)))
        save_png(rng.integers(0, 256, shape, dtype=np.uint8),
                 os.path.join(root, f"doc{i:02d}.png"))
    return find_images(root)


@pytest.mark.parametrize("case", [
    "half steps", "bounds", "the canvas's size", "larger than the canvas",
    "a short tail batch", "clean_dir, one batch in flight"])
def test_the_unet_sees_the_host_formulas_canvases(case, monkeypatch,
                                                  tmp_path):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    seen = _spy(monkeypatch)
    if case == "clean_dir, one batch in flight":
        # 7 documents in batches of 2: 4 batches, each staging buffer
        # written twice, the last batch short
        paths = _write_pngs(str(tmp_path / "in"), rng, 7, *DOC)
        docs, size = [load_gray(p) for p in paths], 2
        res = _cleaner(size).clean_dir(str(tmp_path / "in"),
                                       str(tmp_path / "out"))
        assert res["num_documents"] == 7
    else:
        docs, size = _docs(case, rng)
        out = _cleaner(size).clean_arrays_uint8(docs)
        assert len(out) == len(docs)
    want = [_host_canvases(docs[i:i + size], size, *DOC)
            for i in range(0, len(docs), size)]
    assert len(seen) == len(want)
    for got, ref in zip(seen, want):
        assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape
        np.testing.assert_array_equal(got.numpy(), ref)


def test_clean_dir_on_the_card_equals_clean_arrays_uint8(monkeypatch,
                                                         tmp_path):
    """On CUDA at the serving canvas: `clean_dir` over 5 batches (each
    batch's packing starts while the previous batch's upload and forward
    may still run) writes the PNG bytes of `clean_arrays_uint8` on the same
    documents, and the UNet sees the host formula's canvases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the staging buffers are "
                    "page-locked and the uploads asynchronous only there")
    rng = np.random.default_rng(15)
    doc, size = (400, 512), 8
    paths = _write_pngs(str(tmp_path / "in"), rng, 5 * size, *doc)
    docs = [load_gray(p) for p in paths]
    seen = _spy(monkeypatch)
    cleaner = _cleaner(size, device="cuda", features=32, doc=doc)
    res = cleaner.clean_dir(str(tmp_path / "in"), str(tmp_path / "dir"))
    assert res["num_documents"] == len(docs)
    for got, i in zip(seen, range(0, len(docs), size)):
        np.testing.assert_array_equal(
            got.cpu().numpy(), _host_canvases(docs[i:i + size], size, *doc))
    assert len(seen) == 5
    os.makedirs(tmp_path / "arrays")
    for p, img in zip(paths, cleaner.clean_arrays_uint8(docs)):
        save_png(img, str(tmp_path / "arrays" / os.path.basename(p)))
    for p in paths:
        name = os.path.basename(p)
        with open(tmp_path / "dir" / name, "rb") as a, \
                open(tmp_path / "arrays" / name, "rb") as b:
            assert a.read() == b.read(), name
