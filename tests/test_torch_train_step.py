"""Port parity of the two-phase training step
(`qea_ocr_tpu_torch/train/patch_steps.py`) against the JAX package at equal
weights and inputs: D=4 documents of 64x64, S=2 strip slots, history window
W=2, I=1 jitter copy, UNet(4), CRNN(hidden 16), float32, Adam 1e-3 with
5e-4 coupled decay. One masked strip, one strip whose OCR label did not
arrive and one padded document make the masks bite; labels are feasible
(on the CPU the JAX package's CTC is optax's).

One module-scoped fixture runs each JAX program once and keeps its outputs.

Tolerances. Losses rel 1e-5, doc_out abs 1e-5 (float32 sums in another
order). Gradients: each tensor to 2e-3 of its own largest entry; JAX's are
read back from Adam's first moment after its first step
(mu = 0.1 * (g + wd * p)). That is float32 noise and not a difference of
the models: the port's float32 gradients agree with a float64 run of
itself (checked once by hand, models and losses cast to double) to 1e-7,
while JAX's float32 gradients carry what one activation within
rounding of a ReLU or max-pool boundary does when it falls on the other
side there (with the weight seeds (3, 4) one such flip at `dec3norm1` put
2% on every gradient upstream of it; with (5, 6) it happened at `dec2conv2`;
the seeds used here have none of that size). Parameters after one step:
abs 1e-5 at lr 1e-3, on the entries whose decayed gradient exceeds a
hundredth of its tensor's largest (about a quarter of the CRNN's 5.6
million entries): Adam's first step moves an entry by
lr * g / (|g| + 1e-8), the sign of g, so where g is within that noise of 0
the two sides may step in opposite directions (2e-3 apart) with both being
right; those entries are held by the gradient comparison instead. After the
second step Adam's two moments and step count are compared, which do not
have that sensitivity. Batch statistics abs 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flax_variables_like, jax_variables
from qea_ocr_tpu.models import CRNN as JCRNN
from qea_ocr_tpu.models import UNet as JUNet
from qea_ocr_tpu.train.patch_steps import make_steps as jax_make_steps
from qea_ocr_tpu.train.state import ModelState
from qea_ocr_tpu.train.state import adam_l2 as jax_adam_l2
from qea_ocr_tpu.utils.charmap import CharMap
from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.tools.convert import crnn_state_dict, unet_state_dict
from qea_ocr_tpu_torch.train.patch_steps import make_steps
from qea_ocr_tpu_torch.train.state import adam_l2

D, S, W, I = 4, 2, 2, 1
N = D * S
DOC = (64, 64)
LR, WD = 1e-3, 5e-4
SEEDS = (7, 8)           # of the UNet's and the CRNN's weights
TABLE = N + 3            # three ids no strip of the batch owns
DOC_ARGS = ("images", "bboxes", "strip_mask", "gt_labels", "gt_lengths",
            "strip_ids")
A_ARGS = ("strips", "bb_mask", "hist_labels", "hist_lengths", "hist_valid",
          "loss_weights", "jitter_images", "jitter_labels", "jitter_lengths")
FLAGS = dict(decaying=True, inner_limit_skip=True)


def _batch(cm, strips_of):
    """The step's inputs as numpy arrays; `strips_of(images, bboxes)` gives
    the cleaned strips (N, 1, 32, 128)."""
    rng = np.random.default_rng(0)
    L = cm.max_len
    b = dict(images=rng.random((D, 1, *DOC)).astype(np.float32))
    bboxes = np.zeros((D, S, 4), np.int32)
    bboxes[..., 0] = rng.integers(0, 20, (D, S))
    bboxes[..., 1] = rng.integers(0, 30, (D, S))
    bboxes[..., 2] = bboxes[..., 0] + rng.integers(10, 40, (D, S))
    bboxes[..., 3] = bboxes[..., 1] + rng.integers(8, 20, (D, S))
    b["bboxes"] = bboxes
    b["strip_mask"] = np.ones((D, S), bool)
    b["strip_mask"][0, 1] = False           # a masked strip slot
    b["strip_mask"][3] = False              # a padded tail document
    gt = np.full((D, S, L), cm.pad_id, np.int32)
    gt[..., :3] = rng.integers(1, cm.vocab_size, (D, S, 3))
    b["gt_labels"] = gt
    b["gt_lengths"] = np.full((D, S), 3, np.int32)
    b["strip_ids"] = rng.permutation(TABLE)[:N].astype(np.int32).reshape(D, S)
    b["strips"] = strips_of(b["images"], bboxes)
    b["bb_mask"] = b["strip_mask"].reshape(N).copy()
    b["bb_mask"][2] = False                 # label did not arrive this step
    hist = np.broadcast_to(gt.reshape(N, 1, L), (N, W, L)).copy()
    hist[:, 1, :3] = rng.integers(1, cm.vocab_size, (N, 3))   # an older read
    b["hist_labels"] = hist
    b["hist_lengths"] = np.full((N, W), 3, np.int32)
    valid = np.ones((N, W), bool)
    valid[1::2, 1] = False                  # half the histories are 1 deep
    b["hist_valid"] = valid & b["bb_mask"][:, None]
    b["loss_weights"] = np.asarray([1.0, 0.7], np.float32)
    noise = rng.normal(0, 0.05, (I, *b["strips"].shape)).astype(np.float32)
    b["jitter_images"] = np.clip(b["strips"][None] - noise, 0, 1)
    b["jitter_labels"] = hist[:, 0][None].repeat(I, axis=0)
    b["jitter_lengths"] = np.full((I, N), 3, np.int32)
    return b


def _tables():
    rng = np.random.default_rng(1)
    return (rng.random(TABLE).astype(np.float32),
            rng.random(TABLE).astype(np.float32))


def _snapshot(state):
    """A JAX ModelState as numpy: its variables, and Adam's two moments as
    params-shaped trees. (The next JAX step donates the state's buffers.)"""
    adam = state.opt_state.inner_state[1]
    return dict(jax_variables(state),
                mu=jax.tree_util.tree_map(np.asarray, dict(adam.mu)),
                nu=jax.tree_util.tree_map(np.asarray, dict(adam.nu)))


def _jax_out(out):
    """A JAX phase_b/phase_ab result as numpy."""
    prep, crnn, doc_out, metrics, cer, ent = out[:6]
    res = dict(prep=_snapshot(prep), crnn=_snapshot(crnn),
               doc_out=np.asarray(doc_out),
               cer=np.asarray(cer), ent=np.asarray(ent),
               **{k: np.asarray(v) for k, v in metrics.items()})
    if len(out) == 7:
        res["loss_a"] = float(out[6])
    return res


@pytest.fixture(scope="module")
def world():
    cm = CharMap.default()
    jprep = JUNet(init_features=4, compute_dtype=jnp.float32)
    jcrnn = JCRNN(vocab_size=cm.vocab_size, lstm_hidden=16,
                  compute_dtype=jnp.float32)
    pv = flax_variables_like(
        jprep, UNet(init_features=4,
                    generator=torch.Generator().manual_seed(SEEDS[0])),
        (1, 1, 16, 16), SEEDS[0])
    cv = flax_variables_like(
        jcrnn, CRNN(cm.vocab_size, lstm_hidden=16,
                    generator=torch.Generator().manual_seed(SEEDS[1])),
        (1, 1, 32, 128), SEEDS[1])
    jsteps = jax_make_steps(jprep, jcrnn, cm)

    def states():
        return (ModelState.create(pv, jax_adam_l2(LR, WD)),
                ModelState.create(cv, jax_adam_l2(LR, WD)))

    b = _batch(cm, lambda im, bb: np.asarray(jsteps.prep_extract(
        states()[0], jnp.asarray(im), jnp.asarray(bb))[1]))
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def ab(prep_s, crnn_s, cer, ent, **kw):
        return jsteps.phase_ab(
            prep_s, crnn_s, *(jb[k] for k in DOC_ARGS[:4]), jnp.asarray(cer),
            jnp.asarray(ent), *(jb[k] for k in DOC_ARGS[4:]),
            *(jb[k] for k in A_ARGS), **FLAGS, **kw)

    raw1 = ab(*states(), *_tables(), update_crnn=False)
    step1 = _jax_out(raw1)
    step2 = _jax_out(ab(raw1[0], raw1[1], raw1[4], raw1[5],
                        update_crnn=False))
    prep_s, crnn_s = states()
    cer, ent = _tables()
    b_crnn = _jax_out(jsteps.phase_b(
        prep_s, crnn_s, *(jb[k] for k in DOC_ARGS[:4]), jnp.asarray(cer),
        jnp.asarray(ent), *(jb[k] for k in DOC_ARGS[4:]), update_crnn=True))
    pre_state, pre_loss = jsteps.prep_pretrain_step(states()[0], jb["images"])
    return dict(cm=cm, pv=pv, cv=cv, batch=b, step1=step1, step2=step2,
                b_crnn=b_crnn,
                pretrain=(_snapshot(pre_state), float(pre_loss)),
                jax=(jprep, jcrnn, jsteps, states, jb))


def _port(world, **kw):
    """Fresh port models at the world's weights, their optimizers and steps."""
    cm = world["cm"]
    prep = UNet(init_features=4, compute_dtype=torch.float32)
    prep.load_state_dict(unet_state_dict(world["pv"]), strict=True)
    crnn = CRNN(cm.vocab_size, lstm_hidden=16, compute_dtype=torch.float32)
    crnn.load_state_dict(crnn_state_dict(world["cv"]), strict=True)
    prep.eval()
    crnn.eval()
    steps = make_steps(
        prep, crnn, cm, prep_optimizer=adam_l2(prep.parameters(), LR, WD),
        crnn_optimizer=adam_l2(crnn.parameters(), LR, WD), **kw)
    return prep, crnn, steps


def _adam_steps(optimizer):
    return {int(s["step"]) for s in optimizer.state.values()}


def _tensors(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _ab(steps, t, cer, ent, **kw):
    return steps.phase_ab(
        *(t[k] for k in DOC_ARGS[:4]), cer, ent, *(t[k] for k in DOC_ARGS[4:]),
        *(t[k] for k in A_ARGS), **FLAGS, **kw)


def _named_grads(model):
    return {k: p.grad.numpy() for k, p in model.named_parameters()}


def _jax_grads(state_after, variables_before, convert):
    """JAX's raw gradients of its first step, under the port's names."""
    mu = convert({"params": state_after["mu"],
                  "batch_stats": variables_before["batch_stats"]})
    before = convert(variables_before)
    return {k: mu[k].numpy() / 0.1 - WD * before[k].numpy() for k in mu}


def _close_to_max(got, want, rel, err_msg):
    """|got - want| <= rel * max|want|, the tensor's own scale."""
    assert got.shape == want.shape, err_msg
    worst, scale = np.abs(got - want).max(), np.abs(want).max()
    assert worst <= rel * scale, (err_msg, worst, scale)


def _check_params(model, jax_state, convert, grads, atol=1e-5):
    """Every parameter and batch statistic of `model` after its first step
    against the JAX state; parameters on the entries whose decayed gradient
    (`grads`: the step's raw gradients) is not float32 noise."""
    want = convert(jax_state)
    got = model.state_dict()
    params = dict(model.named_parameters())
    assert set(got) == set(want)
    checked = total = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, w = got[k].detach().numpy(), w.numpy()
        if k in params:
            p = params[k].detach().numpy()
            decayed = np.abs(grads[k] + WD * p)
            sure = decayed > 1e-2 * decayed.max()
            checked += sure.sum()
            total += sure.size
            np.testing.assert_allclose(g[sure], w[sure], atol=atol, rtol=0,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=k)
    assert checked > 0.2 * total, (checked, total)


def _check_step_outputs(got, ref, loss_a=None, later=False):
    """`later`: the step starts from parameters that an earlier step moved,
    where a few entries of either side stepped the other way (see the
    module docstring), so the outputs agree ten times less closely."""
    doc_out, metrics, cer, ent = got[:4]
    rtol, atol = (1e-4, 1e-4) if later else (1e-5, 1e-5)
    np.testing.assert_allclose(metrics["loss"].item(), ref["loss"], rtol=rtol)
    if loss_a is not None:
        np.testing.assert_allclose(loss_a.item(), ref["loss_a"], rtol=rtol)
    np.testing.assert_allclose(doc_out.numpy(), ref["doc_out"], atol=atol)
    np.testing.assert_array_equal(metrics["decoded"].numpy(), ref["decoded"])
    np.testing.assert_array_equal(metrics["decoded_len"].numpy(),
                                  ref["decoded_len"])
    np.testing.assert_array_equal(metrics["cers"].numpy(), ref["cers"])
    np.testing.assert_array_equal(cer.numpy(), ref["cer"])
    np.testing.assert_allclose(ent.numpy(), ref["ent"], rtol=rtol)


def test_make_steps_has_the_seven_entry_points(world):
    _, _, steps = _port(world)
    assert sorted(vars(steps)) == sorted(vars(world["jax"][2]))
    plain = make_steps(*_port(world)[:2], world["cm"])
    t = _tensors(world["batch"])
    with pytest.raises(ValueError, match="prep_optimizer"):
        plain.prep_pretrain_step(t["images"])
    with pytest.raises(ValueError, match="crnn_optimizer"):
        plain.phase_a(*(t[k] for k in A_ARGS), **FLAGS)


def test_prep_extract_feeds_the_step_the_same_strips(world):
    _, _, steps = _port(world)
    t = _tensors(world["batch"])
    _, strips = steps.prep_extract(t["images"], t["bboxes"])
    np.testing.assert_allclose(strips.numpy(), world["batch"]["strips"],
                               atol=1e-6)


@pytest.fixture(scope="module")
def port_steps(world):
    """The port's first and second phase_ab step (update_crnn=False)."""
    prep, crnn, _ = _port(world)
    opts = (adam_l2(prep.parameters(), LR, WD),
            adam_l2(crnn.parameters(), LR, WD))
    steps = make_steps(prep, crnn, world["cm"], prep_optimizer=opts[0],
                       crnn_optimizer=opts[1])
    t = _tensors(world["batch"])
    cer, ent = map(torch.from_numpy, _tables())
    before = (crnn.training, prep.training)
    out1 = _ab(steps, t, cer, ent, update_crnn=False)
    assert (crnn.training, prep.training) == before
    snap = dict(out=tuple(x.clone() if torch.is_tensor(x) else
                          {k: v.clone() for k, v in x.items()} for x in out1),
                prep_sd={k: v.clone() for k, v in prep.state_dict().items()},
                crnn_sd={k: v.clone() for k, v in crnn.state_dict().items()},
                prep_grads=_named_grads(prep), crnn_grads=_named_grads(crnn))
    out2 = _ab(steps, t, cer, ent, update_crnn=False)
    return dict(prep=prep, crnn=crnn, opts=opts, first=snap, out2=out2)


def test_phase_ab_outputs_and_tables_match_jax(world, port_steps):
    ref = world["step1"]
    got = port_steps["first"]["out"]
    _check_step_outputs(got, ref, loss_a=got[4])
    # the tables changed at the unmasked strips' ids and nowhere else
    b = world["batch"]
    cer0, _ = _tables()
    written = np.zeros(TABLE, bool)
    written[b["strip_ids"].reshape(N)[b["strip_mask"].reshape(N)]] = True
    assert written.sum() == 5
    np.testing.assert_array_equal(got[2].numpy()[~written], cer0[~written])
    assert (got[2].numpy()[written] != cer0[written]).all()


def test_phase_ab_gradients_match_jax(world, port_steps):
    first = port_steps["first"]
    for grads, state, variables, convert in (
            (first["prep_grads"], world["step1"]["prep"], world["pv"],
             unet_state_dict),
            (first["crnn_grads"], world["step1"]["crnn"], world["cv"],
             crnn_state_dict)):
        ref = _jax_grads(state, variables, convert)
        assert set(grads) <= set(ref)
        for k, g in grads.items():
            _close_to_max(g, ref[k], 2e-3, k)
        assert max(np.abs(g).max() for g in grads.values()) > 1e-3


def _load(model_cls, sd, **kw):
    m = model_cls(**kw)
    m.load_state_dict(sd)
    return m


def test_phase_ab_updated_parameters_and_statistics_match_jax(world,
                                                              port_steps):
    first = port_steps["first"]
    cm = world["cm"]
    prep = _load(UNet, first["prep_sd"], init_features=4)
    crnn = _load(CRNN, first["crnn_sd"], vocab_size=cm.vocab_size,
                 lstm_hidden=16)
    _check_params(prep, world["step1"]["prep"], unet_state_dict,
                  first["prep_grads"])
    _check_params(crnn, world["step1"]["crnn"], crnn_state_dict,
                  first["crnn_grads"])
    # UNet statistics moved by flax's rule; the CRNN's are frozen
    sd0 = unet_state_dict(world["pv"])
    moved = [k for k in sd0 if "running_var" in k]
    assert moved and all(
        not torch.equal(first["prep_sd"][k], sd0[k]) for k in moved)
    for k, v in crnn_state_dict(world["cv"]).items():
        if "running" in k or "bias_ih" in k:
            assert torch.equal(first["crnn_sd"][k], v), k


def test_second_step_matches_jax(world, port_steps):
    """From the updated states, so Adam's moments and step count are held."""
    ref = world["step2"]
    out2 = port_steps["out2"]
    _check_step_outputs(out2, ref, loss_a=out2[4], later=True)
    for model, opt, state, convert in (
            (port_steps["prep"], port_steps["opts"][0], ref["prep"],
             unet_state_dict),
            (port_steps["crnn"], port_steps["opts"][1], ref["crnn"],
             crnn_state_dict)):
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            want = convert({"params": state[moment],
                            "batch_stats": state["batch_stats"]})
            for k, p in model.named_parameters():
                # 2e-2: the second gradient is taken at parameters that
                # differ where the first step's sign did; a wrong beta or a
                # missed accumulation would show as 10% or more
                _close_to_max(opt.state[p][key].numpy(), want[k].numpy(),
                              2e-2, f"{key} {k}")
    # two phase-A updates of the CRNN, two phase-B updates of the UNet
    assert _adam_steps(port_steps["opts"][0]) == {2}
    assert _adam_steps(port_steps["opts"][1]) == {2}


def test_phase_b_update_crnn_matches_jax(world):
    ref = world["b_crnn"]
    prep, crnn, steps = _port(world)
    t = _tensors(world["batch"])
    cer, ent = map(torch.from_numpy, _tables())
    got = steps.phase_b(*(t[k] for k in DOC_ARGS[:4]), cer, ent,
                        *(t[k] for k in DOC_ARGS[4:]), update_crnn=True)
    _check_step_outputs(got, ref)
    _check_params(prep, ref["prep"], unet_state_dict, _named_grads(prep))
    _check_params(crnn, ref["crnn"], crnn_state_dict, _named_grads(crnn))
    # and with update_crnn=False the CRNN does not move at all
    prep, crnn, steps = _port(world)
    steps.phase_b(*(t[k] for k in DOC_ARGS[:4]), cer, ent,
                  *(t[k] for k in DOC_ARGS[4:]), update_crnn=False)
    for k, v in crnn_state_dict(world["cv"]).items():
        assert torch.equal(crnn.state_dict()[k], v), k


@pytest.mark.parametrize("rows", [0, 2048], ids=["separate", "concatenated"])
def test_phase_a_batching_branches_match_jax(world, rows):
    """Both ways of running phase A's parts through the CRNN give JAX's
    phase-A loss and its updated CRNN (phase B left the CRNN alone)."""
    _, crnn, steps = _port(world, phase_a_batch_rows=rows)
    t = _tensors(world["batch"])
    loss = steps.phase_a(*(t[k] for k in A_ARGS), **FLAGS)
    np.testing.assert_allclose(loss.item(), world["step1"]["loss_a"],
                               rtol=1e-5)
    _check_params(crnn, world["step1"]["crnn"], crnn_state_dict,
                  _named_grads(crnn))


def test_prep_pretrain_step_matches_jax(world):
    state, loss = world["pretrain"]
    prep, _, steps = _port(world)
    got = steps.prep_pretrain_step(torch.from_numpy(world["batch"]["images"]))
    np.testing.assert_allclose(got.item(), loss, rtol=1e-5)
    _check_params(prep, state, unet_state_dict, _named_grads(prep))


def test_schedules_and_learning_rate():
    from qea_ocr_tpu.train import state as jstate
    from qea_ocr_tpu_torch.train import state as tstate

    for epoch in (0, 9, 10, 25):
        assert tstate.step_lr(1e-4, epoch) == jstate.step_lr(1e-4, epoch)
        assert tstate.cosine_lr(5e-5, epoch, 50) \
            == jstate.cosine_lr(5e-5, epoch, 50)
    # a changed learning rate scales Adam's first step, which is lr * sign(g)
    w = torch.nn.Parameter(torch.ones(3))
    opt = adam_l2([w], 1e-3)
    tstate.set_learning_rate(opt, 1e-2)
    w.grad = torch.tensor([1.0, -2.0, 0.5])
    opt.step()
    np.testing.assert_allclose(w.detach().numpy(), [0.99, 1.01, 0.99],
                               rtol=1e-6)


def test_scrub_nonfinite_zeroes_only_bad_entries():
    from qea_ocr_tpu_torch.train.state import scrub_nonfinite

    a = torch.nn.Parameter(torch.zeros(4))
    b = torch.nn.Parameter(torch.zeros(2))
    c = torch.nn.Parameter(torch.zeros(1))           # no gradient at all
    a.grad = torch.tensor([1.0, float("nan"), float("inf"), -float("inf")])
    b.grad = torch.tensor([-3.0, 2.0])
    scrub_nonfinite([a, b, c])
    assert a.grad.tolist() == [1.0, 0.0, 0.0, 0.0]
    assert b.grad.tolist() == [-3.0, 2.0] and c.grad is None


def _slice(t, lo, hi):
    """Documents [lo, hi) of the batch and their strip rows."""
    out = {}
    for k, v in t.items():
        if k in A_ARGS[:5]:
            out[k] = v[lo * S:hi * S]
        elif k.startswith("jitter"):
            out[k] = v[:, lo * S:hi * S]
        elif k == "loss_weights":
            out[k] = v
        else:
            out[k] = v[lo:hi]
    return out


@pytest.mark.parametrize("refresh", [False, True], ids=["stale", "refresh"])
def test_micro_steps_equal_sequential_small_batches(world, refresh):
    """micro_steps=G is G phase_ab calls on the doc-major chunks; with
    micro_refresh each chunk's history strips are re-extracted with the
    current UNet first."""
    G = 2
    t = _tensors(world["batch"])
    prep_m, crnn_m, steps_m = _port(world)
    cer_m, ent_m = map(torch.from_numpy, _tables())
    doc_m, metrics_m, _, _, loss_a_m = _ab(
        steps_m, t, cer_m, ent_m, update_crnn=False, micro_steps=G,
        micro_refresh=refresh)

    prep, crnn, steps = _port(world)
    cer, ent = map(torch.from_numpy, _tables())
    docs, losses, losses_a, cers = [], [], [], []
    for g in range(G):
        sl = _slice(t, g * D // G, (g + 1) * D // G)
        if refresh:
            sl["strips"] = steps.prep_extract(sl["images"], sl["bboxes"])[1]
        do, m, _, _, la = _ab(steps, sl, cer, ent, update_crnn=False)
        docs.append(do)
        losses.append(m["loss"])
        losses_a.append(la)
        cers.append(m["cers"])
    for a, b in ((prep_m, prep), (crnn_m, crnn)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    assert torch.equal(doc_m, torch.cat(docs))
    assert torch.equal(metrics_m["cers"], torch.cat(cers))
    assert torch.equal(cer_m, cer) and torch.equal(ent_m, ent)
    np.testing.assert_allclose(metrics_m["loss"].item(),
                               torch.stack(losses).mean().item(), rtol=1e-6)
    np.testing.assert_allclose(loss_a_m.item(),
                               torch.stack(losses_a).mean().item(), rtol=1e-6)
    if refresh:      # and it is not the stale-strips program
        _, crnn_s, steps_s = _port(world)
        _ab(steps_s, t, *map(torch.from_numpy, _tables()), update_crnn=False,
            micro_steps=G)
        assert not torch.equal(crnn_s.linear.weight, crnn_m.linear.weight)
    with pytest.raises(ValueError, match="micro_steps"):
        _ab(steps, t, cer, ent, update_crnn=False, micro_steps=3)


def test_phase_b_micro_steps_equal_sequential(world):
    G = 2
    t = _tensors(world["batch"])

    def call(steps, b, cer, ent, **kw):
        return steps.phase_b(*(b[k] for k in DOC_ARGS[:4]), cer, ent,
                             *(b[k] for k in DOC_ARGS[4:]),
                             update_crnn=False, **kw)
    prep_m, _, steps_m = _port(world)
    cer_m, ent_m = map(torch.from_numpy, _tables())
    doc_m, metrics_m, _, _ = call(steps_m, t, cer_m, ent_m, micro_steps=G)
    prep, _, steps = _port(world)
    cer, ent = map(torch.from_numpy, _tables())
    outs = [call(steps, _slice(t, g * D // G, (g + 1) * D // G), cer, ent)
            for g in range(G)]
    for (k, x), y in zip(prep_m.state_dict().items(),
                         prep.state_dict().values()):
        assert torch.equal(x, y), k
    assert torch.equal(doc_m, torch.cat([o[0] for o in outs]))
    assert torch.equal(metrics_m["decoded"],
                       torch.cat([o[1]["decoded"] for o in outs]))
    assert torch.equal(cer_m, cer) and torch.equal(ent_m, ent)
    np.testing.assert_allclose(
        metrics_m["loss"].item(),
        torch.stack([o[1]["loss"] for o in outs]).mean().item(), rtol=1e-6)


@pytest.mark.slow
def test_micro_refresh_matches_jax(world):
    """The scanned JAX program (micro_steps=2, micro_refresh) against the
    port's loop; slow because the JAX scan compiles for minutes on the CPU."""
    _, _, jsteps, states, jb = world["jax"]
    cer, ent = _tables()
    ref = _jax_out(jsteps.phase_ab(
        *states(), *(jb[k] for k in DOC_ARGS[:4]), jnp.asarray(cer),
        jnp.asarray(ent), *(jb[k] for k in DOC_ARGS[4:]),
        *(jb[k] for k in A_ARGS), **FLAGS, update_crnn=False, micro_steps=2,
        micro_refresh=True))
    prep, crnn, steps = _port(world)
    got = _ab(steps, _tensors(world["batch"]), torch.from_numpy(cer),
              torch.from_numpy(ent), update_crnn=False, micro_steps=2,
              micro_refresh=True)
    _check_step_outputs(got, ref, loss_a=got[4], later=True)
