"""Port parity: the CTC gradient and the weighted history loss
(`qea_ocr_tpu_torch/ops/cuda/ctc_cuda.py`, `tracking/loss.py`) against the
JAX package on the same numpy inputs.

The gradient's reference is `jax.grad` through the TPU kernels
(`ctc_loss_pallas`, alpha and beta recursions in interpret mode), not
optax, whose gradient on a row no alignment fits is clamped noise. On such
a row the port gives exactly 0, the derivative of the 1e5 clamp and what
`ctc_pallas.py` says of itself. The TPU kernels do not quite: their logZ
there is the -1e30 surrogate, so `exp(alpha + beta - logZ)` is `exp(beta)`
wherever alpha is the surrogate too, a finite non-zero value (entries of
-14 and -33 on the rows below). Those rows are therefore held to 0 on the
port's side and to "finite" on JAX's, and compared on the feasible rows.

Tolerance: abs 1e-5 / rel 1e-4 in float32. Both sides run the same
recursions with the same log-sum-exp guard; exp/log implementations differ
by an ulp or so per step over T = 31 steps, and a gradient entry is a sum of
up to L+1 such exponentials.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qea_ocr_tpu.ops import ctc as jctc
from qea_ocr_tpu.ops.pallas.ctc_pallas import ctc_loss_pallas
from qea_ocr_tpu.tracking.loss import weighted_ctc_loss as j_weighted
from qea_ocr_tpu.tracking.weights import decaying_weights as j_decaying_weights
from qea_ocr_tpu_torch.ops import ctc as tctc
from qea_ocr_tpu_torch.ops.cuda import ctc_cuda
from qea_ocr_tpu_torch.tracking.loss import weighted_ctc_loss as t_weighted
from qea_ocr_tpu_torch.tracking.weights import decaying_weights

T, V, L = 31, 95, 100
ATOL, RTOL = 1e-5, 1e-4


def _log_probs(rng, B):
    x = rng.normal(size=(T, B, V)).astype(np.float32) * 3
    return np.array(jax.nn.log_softmax(jnp.asarray(x), axis=2))


def _labels(rng, lengths):
    labels = np.full((len(lengths), L), V, np.int32)
    for i, n in enumerate(lengths):
        labels[i, :n] = rng.integers(1, V, n)
    return labels


def _grads(lp, labels, lengths, g):
    """d sum_b(g[b] * nll[b]) / d log_probs: (port, JAX), and the port's nll."""
    ref = jax.grad(lambda x: jnp.sum(jnp.asarray(g) * ctc_loss_pallas(
        x, jnp.asarray(labels), jnp.asarray(lengths), V, 0)))(jnp.asarray(lp))
    x = torch.from_numpy(lp).requires_grad_()
    nll = tctc.ctc_loss_samplewise(x, torch.from_numpy(labels),
                                   torch.from_numpy(lengths), pad_id=V)
    (nll * torch.from_numpy(g)).sum().backward()
    return x.grad.numpy(), np.asarray(ref), nll.detach().numpy()


def test_grad_matches_pallas_kernels():
    """B = 16 random rows, non-uniform upstream gradient."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(1, 15, 16).astype(np.int32)
    g = rng.uniform(0.1, 2.0, 16).astype(np.float32)
    got, ref, _ = _grads(_log_probs(rng, 16), _labels(rng, lengths), lengths, g)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_grad_degenerate_and_infeasible_rows():
    """Empty label, one character, 15 repeats of one character (29 of the 31
    frames), a label that just fits, pad inside L, and three rows that no
    alignment fits (20 repeats, 40 symbols, the full L): those score 1e5
    and the port's gradient there is exactly 0; nothing is NaN or infinite."""
    rng = np.random.default_rng(1)
    lengths = np.asarray([0, 1, 15, 15, 9, 20, 40, 100], np.int32)
    labels = _labels(rng, lengths)
    labels[2, :15] = 42
    labels[4, 5:9] = V                 # pad inside the length: counts as blank
    labels[5, :20] = 7
    g = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    got, ref, nll = _grads(_log_probs(rng, 8), labels, lengths, g)
    assert np.isfinite(got).all() and np.isfinite(nll).all()
    assert (nll[5:] == 1e5).all() and (nll[:5] < 1e5).all()
    assert (got[:, 5:] == 0).all() and np.isfinite(ref).all()
    assert np.abs(got[:, :5]).max() > 0.1
    np.testing.assert_allclose(got[:, :5], ref[:, :5], atol=ATOL, rtol=RTOL)


def test_grad_zero_for_length_outside_labels():
    """A length outside [0, L] (the port's own extension) scores 1e5 with
    gradient exactly 0 and leaves its neighbours alone."""
    rng = np.random.default_rng(2)
    lp = torch.from_numpy(_log_probs(rng, 3)).requires_grad_()
    lengths = np.asarray([5, L + 1, -1], np.int32)
    labels = _labels(rng, [5, L, 0])
    nll = ctc_cuda.ctc_nll(lp, torch.from_numpy(labels),
                           torch.from_numpy(lengths), V)
    nll.sum().backward()
    assert nll[1] == 1e5 and nll[2] == 1e5 and nll[0] < 1e5
    assert torch.isfinite(lp.grad).all()
    assert (lp.grad[:, 1:] == 0).all() and lp.grad[:, 0].abs().max() > 0.1


def test_explicit_backward_where_autograd_gives_nan():
    """Why the backward is explicit: autograd through the plain alpha
    recursion multiplies the zero gradient of an unselected `where` branch by
    the infinite derivative of `log(exp(-1e30 - m) ...)`, and returns NaN
    even for rows an alignment fits. The explicit beta recursion is finite
    on the same inputs."""
    rng = np.random.default_rng(3)
    lengths = rng.integers(0, 15, 6).astype(np.int32)
    labels = torch.from_numpy(_labels(rng, lengths))
    lp = torch.from_numpy(_log_probs(rng, 6))
    x = lp.clone().requires_grad_()
    ctc_cuda.ctc_nll(x, labels, torch.from_numpy(lengths), V).sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0.1
    y = lp.clone().requires_grad_()
    ctc_cuda._alpha_plain(y, labels, torch.from_numpy(lengths), V,
                          0)[0].sum().backward()
    assert torch.isnan(y.grad).any()


@pytest.mark.parametrize("seed", [50, 51])
def test_grad_with_logit_lengths_matches_jax(seed):
    """Per-row valid steps T_b, drawn from the seed with T_b = 1 and T_b = T
    among them and rows that fit T but not their T_b: the gradient against
    `jax.grad` through JAX's `ctc_loss_samplewise(logit_lengths=...)` (its
    optax path) on the rows an alignment fits. optax takes a log-softmax of
    its scores, so both sides differentiate through one from the same
    logits. The port's gradient is exactly 0 at every t >= T_b and on the
    rows none fits; JAX's is finite everywhere."""
    rng = np.random.default_rng(seed)
    B = 10
    x = rng.normal(size=(T, B, V)).astype(np.float32) * 3
    lengths = rng.integers(0, 15, B).astype(np.int32)
    lengths[:3] = 0, 14, 12
    labels = _labels(rng, lengths)
    ll = rng.integers(1, T + 1, B).astype(np.int32)
    ll[:3] = 1, T, 9
    labels[2, :12] = 1 + np.arange(12)        # 12 steps needed, 9 given
    g = rng.uniform(0.5, 1.5, B).astype(np.float32)
    ref = np.asarray(jax.grad(lambda a: jnp.sum(jnp.asarray(g) * (
        jctc.ctc_loss_samplewise(
            jax.nn.log_softmax(a, axis=2), jnp.asarray(labels),
            jnp.asarray(lengths), pad_id=V,
            logit_lengths=jnp.asarray(ll)))))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    nll = tctc.ctc_loss_samplewise(
        torch.log_softmax(xt, dim=2), torch.from_numpy(labels),
        torch.from_numpy(lengths), pad_id=V,
        logit_lengths=torch.from_numpy(ll))
    (nll * torch.from_numpy(g)).sum().backward()
    got, nll = xt.grad.numpy(), nll.detach().numpy()
    live = nll < 1e5
    assert not live[2] and live[:2].all() and np.isfinite(ref).all()
    assert (got[:, ~live] == 0).all()
    for b, tb in enumerate(ll):
        assert (got[tb:, b] == 0).all(), b
    assert np.abs(got).max() > 0.1
    np.testing.assert_allclose(got[:, live], ref[:, live], atol=ATOL,
                               rtol=RTOL)


def test_logit_lengths_checked_once(monkeypatch):
    """The check of `logit_lengths` reads them back to the host, so a
    forward and backward through the loss runs it once, at the public
    entry; `_CtcNll` passes the checked tensor on."""
    calls = []
    check = ctc_cuda.check_logit_lengths

    def counted(lp, ll):
        calls.append(1)
        return check(lp, ll)
    monkeypatch.setattr(ctc_cuda, "check_logit_lengths", counted)
    rng = np.random.default_rng(52)
    B = 4
    lengths = np.array([3, 0, 5, 2], np.int32)
    xt = torch.from_numpy(
        rng.normal(size=(T, B, V)).astype(np.float32)).requires_grad_()
    tctc.ctc_loss_mean(
        torch.log_softmax(xt, dim=2), torch.from_numpy(_labels(rng, lengths)),
        torch.from_numpy(lengths), pad_id=V,
        logit_lengths=torch.tensor([T, 1, 20, 7], dtype=torch.int32)
    ).backward()
    assert len(calls) == 1
    assert float(xt.grad.abs().sum()) > 0.0


@pytest.mark.parametrize("decaying", [True, False])
def test_weighted_ctc_loss_value_and_grad(decaying, monkeypatch):
    """Both branches at W = 2 with a sparse validity mask; depth i pairs
    with weight column i. The JAX side runs on the Pallas kernels."""
    monkeypatch.setenv("QEA_CTC_IMPL", "pallas")
    rng = np.random.default_rng(4 + decaying)
    B, W = 6, 2
    lp = _log_probs(rng, B)
    lengths = rng.integers(1, 12, (B, W)).astype(np.int32)
    labels = _labels(rng, lengths.reshape(-1)).reshape(B, W, L)
    valid = rng.random((B, W)) < 0.7
    valid[0] = True
    weights = (decaying_weights(0.7, W).numpy() if decaying
               else rng.uniform(0.1, 1.0, (B, W + 1)).astype(np.float32))
    if decaying:
        np.testing.assert_array_equal(weights,
                                      np.asarray(j_decaying_weights(0.7, W)))

    def j_loss(x):
        return j_weighted(x, jnp.asarray(labels), jnp.asarray(lengths),
                          jnp.asarray(valid), jnp.asarray(weights),
                          pad_id=V, decaying=decaying)
    ref, ref_grad = jax.value_and_grad(j_loss)(jnp.asarray(lp))
    x = torch.from_numpy(lp).requires_grad_()
    got = t_weighted(x, torch.from_numpy(labels), torch.from_numpy(lengths),
                     torch.from_numpy(valid), torch.from_numpy(weights),
                     pad_id=V, decaying=decaying)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=2e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad),
                               atol=ATOL, rtol=RTOL)
