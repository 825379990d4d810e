"""Port parity of the inference slice as a whole: the validation forward of
the patch trainer and the serving path, against the JAX package under the
same weights and inputs.

`val_forward`: both sides in float32 at small widths (UNet(4),
CRNN(hidden 16)), with the JAX side forced onto its TPU kernels in interpret
mode (QEA_GATHER_IMPL / QEA_CTC_IMPL = pallas). Tolerances: doc_out and
strips 1e-6 absolute (float32 convs summed in another order), loss 1e-5
relative; the decode must match exactly.

Serving: a flax UNet checkpoint goes through `export_torch.export_prep` into
the port's `DocumentCleaner`; both run their default bfloat16 policy, so
cleaned uint8 pixels may differ by one level where a value sits on a
rounding boundary, and by no more.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flax_variables_like
from qea_ocr_tpu.data.datasets import PatchDocuments
from qea_ocr_tpu.data.pipeline import collate_docs
from qea_ocr_tpu.data.synth import make_document
from qea_ocr_tpu.models import CRNN as JCRNN
from qea_ocr_tpu.models import UNet as JUNet
from qea_ocr_tpu.train.patch_steps import make_steps as jax_make_steps
from qea_ocr_tpu.train.state import ModelState, adam_l2
from qea_ocr_tpu.utils.charmap import CharMap
from qea_ocr_tpu_torch.data import doc_batch_to
from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.tools.convert import crnn_state_dict, unet_state_dict
from qea_ocr_tpu_torch.train.patch_steps import make_steps

DOC = (64, 256)   # smallest document the TPU gather kernel takes


def _flax_unet_variables(seed):
    return flax_variables_like(
        JUNet(init_features=4),
        UNet(init_features=4, generator=torch.Generator().manual_seed(seed)),
        (1, 1, 16, 16), seed)


@pytest.fixture(scope="module")
def slice_pair():
    cm = CharMap.default()
    jprep = JUNet(init_features=4, compute_dtype=jnp.float32)
    jcrnn = JCRNN(vocab_size=cm.vocab_size, lstm_hidden=16,
                  compute_dtype=jnp.float32)
    pv = _flax_unet_variables(3)
    cv = flax_variables_like(
        jcrnn, CRNN(cm.vocab_size, lstm_hidden=16,
                    generator=torch.Generator().manual_seed(4)),
        (1, 1, 32, 128), 4)
    prep = UNet(init_features=4, compute_dtype=torch.float32)
    prep.load_state_dict(unet_state_dict(pv), strict=True)
    crnn = CRNN(cm.vocab_size, lstm_hidden=16, compute_dtype=torch.float32)
    crnn.load_state_dict(crnn_state_dict(cv), strict=True)
    batch = collate_docs(list(PatchDocuments.synthetic(
        3, seed=5, n_strips=3, max_strips=4, doc_size=DOC)))
    batch.strip_mask[2] = False          # a padded tail document
    return dict(cm=cm, jprep=jprep, jcrnn=jcrnn, pv=pv, cv=cv, prep=prep,
                crnn=crnn, batch=batch)


def test_val_forward_matches_jax(slice_pair, monkeypatch):
    monkeypatch.setenv("QEA_GATHER_IMPL", "pallas")
    monkeypatch.setenv("QEA_CTC_IMPL", "pallas")
    p = slice_pair
    b = p["batch"]
    jsteps = jax_make_steps(p["jprep"], p["jcrnn"], p["cm"])
    ref = jsteps.val_forward(
        ModelState.create(p["pv"], adam_l2(1e-4)),
        ModelState.create(p["cv"], adam_l2(1e-4)),
        *map(jnp.asarray, (b.images, b.bboxes, b.strip_mask, b.gt_labels,
                           b.gt_lengths)))
    t = doc_batch_to(b, torch.device("cpu"))
    got = make_steps(p["prep"], p["crnn"], p["cm"]).val_forward(
        t.images, t.bboxes, t.strip_mask, t.gt_labels, t.gt_lengths)
    doc_out, strips, dec, dec_len, loss = (x.numpy() for x in got)
    assert doc_out.shape == (3, 1, *DOC) and strips.shape == (12, 1, 32, 128)
    np.testing.assert_allclose(doc_out, np.asarray(ref[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(strips, np.asarray(ref[1]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(dec, np.asarray(ref[2]))
    np.testing.assert_array_equal(dec_len, np.asarray(ref[3]))
    np.testing.assert_allclose(loss, float(ref[4]), rtol=1e-5)


def test_prep_extract_and_entropy_match_jax(slice_pair):
    p = slice_pair
    b = p["batch"]
    jsteps = jax_make_steps(p["jprep"], p["jcrnn"], p["cm"])
    steps = make_steps(p["prep"], p["crnn"], p["cm"])
    t = doc_batch_to(b, torch.device("cpu"))
    doc_out, strips = steps.prep_extract(t.images, t.bboxes)
    ref_doc, ref_strips = jsteps.prep_extract(
        ModelState.create(p["pv"], adam_l2(1e-4)), jnp.asarray(b.images),
        jnp.asarray(b.bboxes))
    np.testing.assert_allclose(doc_out.numpy(), np.asarray(ref_doc), atol=1e-6)
    np.testing.assert_allclose(strips.numpy(), np.asarray(ref_strips),
                               atol=1e-6)
    ent = steps.entropy_of(strips)
    ref_ent = jsteps.entropy_of(ModelState.create(p["cv"], adam_l2(1e-4)),
                                jnp.asarray(strips.numpy()))
    np.testing.assert_allclose(ent.numpy(), np.asarray(ref_ent), rtol=1e-5)
    # the steps leave each model's train/eval mode as they found it
    assert p["prep"].training and p["crnn"].training


@pytest.fixture(scope="module")
def exported_prep(tmp_path_factory):
    """A flax UNet(4) orbax checkpoint and its `export_prep` state_dict."""
    from qea_ocr_tpu.tools.export_torch import export_prep
    from qea_ocr_tpu.utils.io import save_checkpoint

    v = _flax_unet_variables(7)
    d = tmp_path_factory.mktemp("serve")
    ckpt = str(d / "prep")
    save_checkpoint(ckpt, ModelState.create(v, adam_l2(1e-4)))
    pt = str(d / "prep.pt")
    export_prep(ckpt, pt, unet_features=4)
    return ckpt, pt


def test_document_cleaner_matches_jax(exported_prep):
    from qea_ocr_tpu.serve import DocumentCleaner as JaxCleaner
    from qea_ocr_tpu_torch.serve.cleaner import DocumentCleaner

    ckpt, pt = exported_prep
    doc = (64, 128)
    rng = np.random.default_rng(1)
    imgs = [rng.random((40, 90), dtype=np.float32),          # padded
            rng.random(doc, dtype=np.float32),               # exact
            rng.random((doc[0] * 2, doc[1] * 3), dtype=np.float32)]  # shrunk
    ref = JaxCleaner(ckpt, unet_features=4, doc_size=doc,
                     batch_size=2).clean_arrays(imgs)
    cleaner = DocumentCleaner(pt, device="cpu", unet_features=4,
                              doc_size=doc, batch_size=2)
    got_u8 = cleaner.clean_arrays_uint8(imgs)
    got = cleaner.clean_arrays(imgs)
    for u8, g, r in zip(got_u8, got, ref):
        assert u8.dtype == np.uint8 and g.shape == r.shape == u8.shape
        np.testing.assert_array_equal(g, u8.astype(np.float32) / 255.0)
        assert np.abs(g * 255.0 - r * 255.0).max() <= 1.0 + 1e-4
    assert got[0].shape == (40, 90) and got[2].shape == (43, 128)


def test_clean_docs_cli(exported_prep, tmp_path, capsys):
    from qea_ocr_tpu_torch.cli.clean_docs import main
    from qea_ocr_tpu_torch.serve.cleaner import save_png

    _, pt = exported_prep
    in_dir = tmp_path / "docs"
    rng = np.random.default_rng(0)
    for sub in ("a", "b"):
        os.makedirs(in_dir / sub)
        for i in range(2):
            img, _ = make_document(rng, doc_h=64, doc_w=128, n_strips=2)
            save_png((img * 255).astype(np.uint8),
                     str(in_dir / sub / f"page{i}.png"))
    tpath = str(tmp_path / "transcripts.json")
    main(["--prep_path", pt, "--input_dir", str(in_dir), "--output_dir",
          str(tmp_path / "out"), "--ocr", "Fake", "--transcripts", tpath,
          "--batch_size", "3", "--unet_features", "4", "--doc_size", "64",
          "128", "--device", "cpu"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["num_documents"] == 4
    assert sorted(os.listdir(tmp_path / "out")) == [
        "a__page0.png", "a__page1.png", "b__page0.png", "b__page1.png"]
    assert sorted(json.load(open(tpath))) == [
        "a/page0.png", "a/page1.png", "b/page0.png", "b/page1.png"]
