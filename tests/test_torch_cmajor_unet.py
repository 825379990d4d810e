"""The port's channel-major UNet twin (`models/unet.py`, `conv_impl="cmajor"`;
plain conv version on CPU tensors) against the JAX `conv_impl="cmajor"` UNet
(Pallas kernel in interpret mode) and against the port's own vanilla layout,
at equal weights; and the trainer's split of the two through
`make_steps(prep_eval_model=...)`.

Tolerances are those of the JAX package's `tests/test_cmajor_unet.py`: eval
forward 2e-3 on the sigmoid output (bfloat16 rounding at other places in the
two layouts; observed 2e-4 to 1e-3), train forward 0.08 and batch statistics
5e-3 (bfloat16 normalisation rounding compounds through 8 batch norms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qea_ocr_tpu.models import UNet as JUNet
from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.models.unet import (
    UNet, cmajor_supported, flat_batch_norm, resolve_conv_impl)
from qea_ocr_tpu_torch.ops.conv_cmajor import pad_flat, unflat
from qea_ocr_tpu_torch.tools.convert import unet_state_dict
from qea_ocr_tpu_torch.train.patch_steps import make_steps
from qea_ocr_tpu_torch.train.state import adam_l2
from qea_ocr_tpu_torch.utils.charmap import CharMap

from _torch_parity import flax_variables_like

F_, H, W = 4, 16, 256     # the JAX kernel needs W % 128 == 0 at levels 1, 2


@pytest.fixture(scope="module")
def world():
    """Seeded weights in both frameworks, the JAX cmajor outputs (eval and
    train) computed once."""
    x = np.random.default_rng(0).random((2, 1, H, W), dtype=np.float32)
    seed_model = UNet(init_features=F_, conv_impl="xla",
                      generator=torch.Generator().manual_seed(3))
    jmodel = JUNet(init_features=F_, conv_impl="cmajor")
    variables = flax_variables_like(jmodel, seed_model, (1, 1, H, W), seed=5)
    sd = unet_state_dict(variables)
    jx = jnp.asarray(x)
    j_eval = np.asarray(jmodel.apply(variables, jx, train=False))
    j_train, j_mut = jmodel.apply(variables, jx, train=True,
                                  mutable=["batch_stats"])
    j_stats = unet_state_dict({"params": variables["params"],
                               "batch_stats": jax.tree_util.tree_map(
                                   np.asarray, j_mut["batch_stats"])})
    return dict(x=torch.from_numpy(x), sd=sd, j_eval=j_eval,
                j_train=np.asarray(j_train), j_stats=j_stats)


def _pair(world):
    vanilla = UNet(init_features=F_, conv_impl="xla")
    vanilla.load_state_dict(world["sd"])
    return vanilla, vanilla.twin("cmajor")


def _stat_diff(sd_a, sd_b):
    return max(float((sd_a[k].float() - sd_b[k].float()).abs().max())
               for k in sd_a if "running_" in k)


def test_state_dict_keys_equal_and_tensors_shared(world):
    vanilla, twin = _pair(world)
    assert list(vanilla.state_dict()) == list(twin.state_dict())
    assert twin.conv_impl == "cmajor" and vanilla.conv_impl == "xla"
    assert vanilla.shares_state(twin)
    for (ka, a), (kb, b) in zip(vanilla.state_dict(keep_vars=True).items(),
                                twin.state_dict(keep_vars=True).items()):
        assert ka == kb and a is b, ka
    fresh = UNet(init_features=F_, conv_impl="cmajor")
    fresh.load_state_dict(world["sd"])          # one state_dict serves both
    assert not vanilla.shares_state(fresh)


def test_eval_forward_matches_jax_cmajor_and_vanilla(world):
    vanilla, twin = _pair(world)
    vanilla.eval(), twin.eval()
    with torch.no_grad():
        yc, yv = twin(world["x"]), vanilla(world["x"])
    assert yc.shape == yv.shape == world["x"].shape
    assert yc.dtype == torch.float32
    assert float(np.abs(yc.numpy() - world["j_eval"]).max()) < 2e-3
    assert float((yc - yv).abs().max()) < 2e-3


def test_fused_eval_matches_unfused(world, monkeypatch):
    _, twin = _pair(world)
    twin.eval()
    with torch.no_grad():
        fused = twin(world["x"])
        monkeypatch.setenv("QEA_CMAJOR_FUSED", "0")
        unfused = twin(world["x"])
    assert not torch.equal(fused, unfused)      # the fold rounds elsewhere
    assert float((fused - unfused).abs().max()) < 2e-3


def test_train_forward_and_statistics_match_jax_cmajor_and_vanilla(world):
    vanilla, twin = _pair(world)
    vanilla.train(), twin.train()
    before = {k: v.clone() for k, v in vanilla.state_dict().items()}
    with torch.no_grad():
        yc = twin(world["x"])
        after_twin = {k: v.clone() for k, v in twin.state_dict().items()}
        vanilla.load_state_dict(before)
        yv = vanilla(world["x"])
        after_vanilla = vanilla.state_dict()
    assert float(np.abs(yc.numpy() - world["j_train"]).max()) < 0.08
    assert float((yc - yv).abs().max()) < 0.08
    assert _stat_diff(after_twin, world["j_stats"]) < 5e-3
    assert _stat_diff(after_twin, after_vanilla) < 5e-3
    assert _stat_diff(after_twin, before) > 1e-3        # they did move


def test_gradients_flow_through_the_twin(world):
    """Every parameter takes a finite, non-zero gradient through the flat
    blocks (the conv's autograd function, the flat batch norm's sums)."""
    _, twin = _pair(world)
    twin.train()
    twin(world["x"]).square().sum().backward()
    for name, p in twin.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert float(p.grad.abs().max()) > 0, name


def test_flat_batch_norm_exact_on_zero_halos_and_stores_biased_variance():
    B, C, h, w = 3, 5, 8, 16
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, C, h, w)).astype(np.float32))
    xf = torch.nn.functional.pad(x, (0, 0, 1, 1)).reshape(B, C, (h + 2) * w)
    bn = torch.nn.BatchNorm2d(C, eps=1e-5, momentum=0.1).train()
    got = flat_batch_norm(bn, xf, h, w, torch.float32)
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    ref = (x - mean[None, :, None, None]) / torch.sqrt(
        var + 1e-5)[None, :, None, None]
    np.testing.assert_allclose(unflat(got, h, w).detach().numpy(),
                               ref.numpy(), atol=2e-5)
    # flax's rule: 0.9 * old + 0.1 * batch, with the biased batch variance
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 + 0.1 * var.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="fold"):
        flat_batch_norm(bn, None, h, w, torch.float32, fold=True)


def test_resolve_conv_impl(monkeypatch):
    monkeypatch.delenv("QEA_CONV_IMPL", raising=False)
    assert cmajor_supported(16, 256, F_)
    assert cmajor_supported(16, 192, F_)         # no lane rule here
    assert cmajor_supported(400, 512, 32) and cmajor_supported(512, 512, 32)
    assert not cmajor_supported(18, 256, F_)     # the UNet's own rule: % 16
    assert resolve_conv_impl("xla", 16, 256, F_) == "xla"
    assert resolve_conv_impl("cmajor", 16, 256, F_) == "cmajor"
    assert resolve_conv_impl("auto", 16, 256, F_) == "xla"
    with pytest.raises(ValueError):
        resolve_conv_impl("cmajor", 18, 256, F_)
    with pytest.raises(ValueError):
        resolve_conv_impl("cudnn", 16, 256, F_)
    monkeypatch.setenv("QEA_CONV_IMPL", "cmajor")
    assert resolve_conv_impl("auto", 16, 256, F_) == "cmajor"
    assert resolve_conv_impl("xla", 16, 256, F_) == "xla"
    # the environment's choice raises outside the coverage as the
    # argument's does: no retreat to the library route
    with pytest.raises(ValueError, match="does not cover"):
        resolve_conv_impl("auto", 18, 256, F_)
    # read when the model is built, not later
    model = UNet(init_features=F_)
    with pytest.raises(ValueError, match="does not cover"):
        model(torch.zeros(1, 1, 18, 256))
    monkeypatch.delenv("QEA_CONV_IMPL")
    assert model.conv_impl == "cmajor"
    assert UNet(init_features=F_).conv_impl == "xla"


# ----------------------------------------------------- the trainer's split
def _steps_world(world):
    cm = CharMap.default()
    vanilla, twin = _pair(world)
    crnn = CRNN(cm.vocab_size, lstm_hidden=16,
                generator=torch.Generator().manual_seed(4))
    D, S = 2, 2
    bboxes = torch.zeros((D, S, 4), dtype=torch.int32)
    bboxes[..., 2], bboxes[..., 3] = 64, 12
    labels = torch.zeros((D, S, cm.max_len), dtype=torch.int32)
    lengths = torch.ones((D, S), dtype=torch.int32)
    mask = torch.ones((D, S), dtype=torch.bool)
    return cm, vanilla, twin, crnn, bboxes, labels, lengths, mask


def test_make_steps_routes_no_grad_forwards_through_the_twin(world):
    cm, vanilla, twin, crnn, bboxes, labels, lengths, mask = \
        _steps_world(world)
    calls = {"twin": 0, "vanilla": 0}
    twin.register_forward_hook(
        lambda *a: calls.__setitem__("twin", calls["twin"] + 1))
    vanilla.register_forward_hook(
        lambda *a: calls.__setitem__("vanilla", calls["vanilla"] + 1))
    ref = make_steps(vanilla, crnn, cm)
    doc_ref, strips_ref = ref.prep_extract(world["x"], bboxes)
    out_ref = ref.val_forward(world["x"], bboxes, mask, labels, lengths)
    assert calls == {"twin": 0, "vanilla": 2}

    split = make_steps(
        vanilla, crnn, cm, prep_eval_model=twin,
        prep_optimizer=adam_l2(vanilla.parameters(), 1e-3),
        crnn_optimizer=adam_l2(crnn.parameters(), 1e-3))
    doc_spl, strips_spl = split.prep_extract(world["x"], bboxes)
    out_spl = split.val_forward(world["x"], bboxes, mask, labels, lengths)
    assert calls == {"twin": 2, "vanilla": 2}
    assert float((doc_spl - doc_ref).abs().max()) < 2e-3
    assert float((strips_spl - strips_ref).abs().max()) < 2e-3
    assert float((out_spl[0] - out_ref[0]).abs().max()) < 2e-3
    assert torch.isfinite(out_spl[4])
    assert abs(float(out_spl[4]) - float(out_ref[4])) \
        < 1e-2 * abs(float(out_ref[4]))

    # everything that takes a gradient runs through the grad model
    N = bboxes.shape[0] * bboxes.shape[1]
    table = torch.ones(8)
    split.prep_pretrain_step(world["x"])
    split.phase_b(world["x"], bboxes, mask, labels, table, table.clone(),
                  lengths, torch.arange(N, dtype=torch.int32).reshape(2, 2),
                  update_crnn=False)
    assert calls == {"twin": 2, "vanilla": 4}


def test_a_twin_with_its_own_tensors_is_refused(world):
    cm, vanilla, _, crnn, *_ = _steps_world(world)
    stranger = UNet(init_features=F_, conv_impl="cmajor")
    stranger.load_state_dict(world["sd"])
    with pytest.raises(ValueError, match="twin"):
        make_steps(vanilla, crnn, cm, prep_eval_model=stranger)


def test_twin_sees_an_optimizer_step_and_new_statistics(world):
    """One `phase_b` step (a UNet update with train-mode batch norm) through
    the grad model; then the twin's `prep_extract` equals the grad model's
    eval forward within the layout tolerance, and differs from what it gave
    before the step. The optimizer holds each parameter once."""
    cm, vanilla, twin, crnn, bboxes, labels, lengths, mask = \
        _steps_world(world)
    prep_opt = adam_l2(vanilla.parameters(), 5e-2)
    n_params = sum(len(g["params"]) for g in prep_opt.param_groups)
    assert n_params == len(list(vanilla.parameters())) \
        == len(list(twin.parameters()))
    assert len({id(p) for g in prep_opt.param_groups
                for p in g["params"]}) == n_params
    steps = make_steps(vanilla, crnn, cm, prep_eval_model=twin,
                       prep_optimizer=prep_opt,
                       crnn_optimizer=adam_l2(crnn.parameters(), 1e-3))
    doc_before, _ = steps.prep_extract(world["x"], bboxes)
    stats_before = {k: v.clone() for k, v in twin.state_dict().items()}
    table = torch.ones(8)
    steps.phase_b(world["x"], bboxes, mask, labels, table, table.clone(),
                  lengths, torch.arange(4, dtype=torch.int32).reshape(2, 2),
                  update_crnn=False)
    assert vanilla.shares_state(twin)
    assert _stat_diff(twin.state_dict(), stats_before) > 1e-3
    doc_after, _ = steps.prep_extract(world["x"], bboxes)
    vanilla.eval()
    with torch.no_grad():
        want = vanilla(world["x"])
    assert float((doc_after - want).abs().max()) < 2e-3
    assert float((doc_after - doc_before).abs().max()) > 1e-2
