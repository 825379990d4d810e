"""Port parity of the area path's step functions
(`qea_ocr_tpu_torch/train/area_trainer.py:make_area_steps`) against the JAX
package's at equal weights and inputs: B=8 synthetic word crops of 32x128
with their ground-truth labels, UNet(4), CRNN(hidden 16), Adam 1e-3 with
5e-4 coupled decay, sec_loss_scalar 0.5, a CER/entropy table of B+3 rows.
Phase A is the patch step's (`tests/test_torch_train_step.py` holds it).

One module-scoped fixture runs each JAX program once and keeps its outputs.

The port runs in float32. The JAX reference runs its UNet in float64
(`jax.enable_x64`; its CRNN stays float32, whose LSTM carry is float32 by
construction): on these mostly-white crops JAX's own float32 UNet gradients
in the deep levels are off from its float64 ones by up to 4.2% of a tensor's
largest entry (bottleneck conv2; 3.5e-3 at enc1conv1), while the port's
float32 gradients agree with a float64 run of the port to 4e-6 (both measured
once on this batch). Against the float64 reference the tolerances and the
per-tensor rule are those of `tests/test_torch_train_step.py` (its docstring
says why): loss rel 1e-5, the UNet's output abs 1e-5, decodes, CERs and the
CER table equal, the entropy table rel 1e-5; gradients, each tensor to 2e-3
of its own largest entry (JAX's read back from Adam's first moment);
parameters after the step abs 1e-5 on the entries whose decayed gradient
exceeds a hundredth of its tensor's largest; batch statistics abs 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flax_variables_like
from qea_ocr_tpu.models import CRNN as JCRNN
from qea_ocr_tpu.models import UNet as JUNet
from qea_ocr_tpu.train.area_trainer import (
    make_area_steps as jax_make_area_steps)
from qea_ocr_tpu.train.state import ModelState
from qea_ocr_tpu.train.state import adam_l2 as jax_adam_l2
from qea_ocr_tpu_torch.data.datasets import SyntheticWordDataset
from qea_ocr_tpu_torch.data.pipeline import collate_words, pad_wordbatch
from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.tools.convert import crnn_state_dict, unet_state_dict
from qea_ocr_tpu_torch.train.area_trainer import make_area_steps
from qea_ocr_tpu_torch.train.state import adam_l2
from qea_ocr_tpu_torch.utils.charmap import CharMap
from test_torch_train_step import (
    LR, WD, _check_params, _close_to_max, _jax_grads, _named_grads,
    _snapshot)

B = 8
TABLE = B + 3
SCALAR = 0.5
SEEDS = (21, 22)         # of the UNet's and the CRNN's weights
REAL = 6                 # validation: 6 real crops and 2 padding rows


def _tables():
    rng = np.random.default_rng(1)
    return (rng.random(TABLE).astype(np.float32),
            rng.random(TABLE).astype(np.float32))


@pytest.fixture(scope="module")
def world():
    cm = CharMap.default()
    jprep = JUNet(init_features=4, compute_dtype=jnp.float32)   # its tree
    jcrnn = JCRNN(vocab_size=cm.vocab_size, lstm_hidden=16,
                  compute_dtype=jnp.float32)
    pv = flax_variables_like(
        jprep, UNet(init_features=4,
                    generator=torch.Generator().manual_seed(SEEDS[0])),
        (1, 1, 32, 128), SEEDS[0])
    cv = flax_variables_like(
        jcrnn, CRNN(cm.vocab_size, lstm_hidden=16,
                    generator=torch.Generator().manual_seed(SEEDS[1])),
        (1, 1, 32, 128), SEEDS[1])
    ds = SyntheticWordDataset(B + REAL, seed=5)
    words = collate_words([ds[i] for i in range(B)], cm)
    val = pad_wordbatch(collate_words([ds[B + i] for i in range(REAL)], cm),
                        B)
    ids = np.random.default_rng(2).permutation(TABLE)[:B].astype(np.int32)
    b = dict(images=words.images, labels=words.labels,
             lengths=words.lengths, ids=ids, val_images=val.images,
             val_labels=val.labels, val_lengths=val.lengths,
             mask=np.arange(B) < REAL)
    assert words.lengths.min() > 0 and words.lengths.max() <= 15
    with jax.enable_x64(True):
        f64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), pv)
        jb = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32 else None)
              for k, v in b.items()}
        jsteps = jax_make_area_steps(
            JUNet(init_features=4, compute_dtype=jnp.float64), jcrnn, cm,
            sec_loss_scalar=SCALAR)

        def states():
            return (ModelState.create(f64, jax_adam_l2(LR, WD)),
                    ModelState.create(cv, jax_adam_l2(LR, WD)))

        phase_b = {}
        for update_crnn in (False, True):
            cer, ent = _tables()
            prep_s, crnn_s, img_out, metrics, cer, ent = jsteps.phase_b(
                *states(), jb["images"], jb["labels"], jnp.asarray(cer),
                jnp.asarray(ent), jb["lengths"], jb["ids"],
                update_crnn=update_crnn)
            phase_b[update_crnn] = dict(
                prep=_snapshot(prep_s), crnn=_snapshot(crnn_s),
                img_out=np.asarray(img_out), loss=float(metrics["loss"]),
                cers=np.asarray(metrics["cers"]), cer=np.asarray(cer),
                ent=np.asarray(ent))
        pre_state, pre_loss = jsteps.prep_pretrain_step(states()[0],
                                                        jb["images"])
        pretrain = (_snapshot(pre_state), float(pre_loss))
        val = [np.asarray(x) for x in jsteps.val_forward(
            *states(), jb["val_images"], jb["val_labels"],
            jb["val_lengths"], jb["mask"])]
    return dict(cm=cm, pv=pv, cv=cv, batch=b, phase_b=phase_b,
                pretrain=pretrain, val=val, jax_names=sorted(vars(jsteps)))


def _port(world):
    """Fresh port models at the world's weights, and their steps."""
    cm = world["cm"]
    prep = UNet(init_features=4, compute_dtype=torch.float32)
    prep.load_state_dict(unet_state_dict(world["pv"]), strict=True)
    crnn = CRNN(cm.vocab_size, lstm_hidden=16, compute_dtype=torch.float32)
    crnn.load_state_dict(crnn_state_dict(world["cv"]), strict=True)
    prep.eval()
    crnn.eval()
    steps = make_area_steps(
        prep, crnn, cm, prep_optimizer=adam_l2(prep.parameters(), LR, WD),
        crnn_optimizer=adam_l2(crnn.parameters(), LR, WD),
        sec_loss_scalar=SCALAR)
    return prep, crnn, steps


def _t(world, *keys):
    return [torch.from_numpy(np.array(world["batch"][k])) for k in keys]


def test_area_steps_are_the_jax_ones(world):
    prep, crnn, steps = _port(world)
    assert sorted(vars(steps)) == world["jax_names"]
    plain = make_area_steps(prep, crnn, world["cm"])
    images, labels, lengths, ids = _t(world, "images", "labels", "lengths",
                                      "ids")
    cer, ent = map(torch.from_numpy, _tables())
    with pytest.raises(ValueError, match="optimizers"):
        plain.phase_b(images, labels, cer, ent, lengths, ids,
                      update_crnn=False)
    # prep_forward is the UNet's eval-mode output (JAX's val_forward gives
    # it on the validation crops), with no gradient
    val_images, = _t(world, "val_images")
    out = steps.prep_forward(val_images)
    assert not out.requires_grad and not prep.training
    np.testing.assert_allclose(out.numpy(), world["val"][0], atol=1e-5)


@pytest.mark.parametrize("update_crnn", [False, True],
                         ids=["prep_only", "update_crnn"])
def test_phase_b_matches_jax(world, update_crnn):
    ref = world["phase_b"][update_crnn]
    prep, crnn, steps = _port(world)
    images, labels, lengths, ids = _t(world, "images", "labels", "lengths",
                                      "ids")
    cer, ent = map(torch.from_numpy, _tables())
    cer0 = cer.clone()
    img_out, metrics, cer_out, ent_out = steps.phase_b(
        images, labels, cer, ent, lengths, ids, update_crnn=update_crnn)
    assert cer_out is cer and ent_out is ent          # updated in place
    assert not prep.training and not crnn.training    # modes restored
    np.testing.assert_allclose(metrics["loss"].item(), ref["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(img_out.numpy(), ref["img_out"], atol=1e-5)
    np.testing.assert_array_equal(metrics["cers"].numpy(), ref["cers"])
    np.testing.assert_array_equal(cer.numpy(), ref["cer"])
    np.testing.assert_allclose(ent.numpy(), ref["ent"], rtol=1e-5)
    # the tables changed at the batch's ids and nowhere else
    others = np.setdiff1d(np.arange(TABLE), world["batch"]["ids"])
    np.testing.assert_array_equal(cer.numpy()[others], cer0.numpy()[others])

    grads = _named_grads(prep)
    for k, g in grads.items():
        _close_to_max(g, _jax_grads(ref["prep"], world["pv"],
                                    unet_state_dict)[k], 2e-3, k)
    _check_params(prep, ref["prep"], unet_state_dict, grads)
    sd0 = unet_state_dict(world["pv"])
    assert all(not torch.equal(prep.state_dict()[k], sd0[k])
               for k in sd0 if "running_var" in k)
    if update_crnn:
        cgrads = _named_grads(crnn)
        want = _jax_grads(ref["crnn"], world["cv"], crnn_state_dict)
        for k, g in cgrads.items():
            _close_to_max(g, want[k], 2e-3, k)
        _check_params(crnn, ref["crnn"], crnn_state_dict, cgrads)
    # the CRNN's batch statistics are frozen either way, and without
    # update_crnn nothing of it moves
    for k, v in crnn_state_dict(world["cv"]).items():
        if not update_crnn or "running" in k or "bias_ih" in k:
            assert torch.equal(crnn.state_dict()[k], v), k


def test_prep_pretrain_step_matches_jax(world):
    state, loss = world["pretrain"]
    prep, _, steps = _port(world)
    images, = _t(world, "images")
    got = steps.prep_pretrain_step(images)
    np.testing.assert_allclose(got.item(), loss, rtol=1e-5)
    _check_params(prep, state, unet_state_dict, _named_grads(prep))


def test_val_forward_masks_the_padding_rows(world):
    img_ref, dec_ref, len_ref, loss_ref = world["val"]
    _, _, steps = _port(world)
    images, labels, lengths, mask = _t(world, "val_images", "val_labels",
                                       "val_lengths", "mask")
    img_out, dec, dec_len, loss = steps.val_forward(images, labels, lengths,
                                                    mask)
    np.testing.assert_allclose(img_out.numpy(), img_ref, atol=1e-5)
    np.testing.assert_array_equal(dec.numpy(), dec_ref)
    np.testing.assert_array_equal(dec_len.numpy(), len_ref)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    # what lies in the padding rows does not reach the loss
    noisy = images.clone()
    noisy[REAL:] = torch.rand(noisy[REAL:].shape,
                              generator=torch.Generator().manual_seed(0))
    assert steps.val_forward(noisy, labels, lengths, mask)[3].item() \
        == pytest.approx(loss.item(), rel=1e-6)
