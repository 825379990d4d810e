"""Port parity: CTC loss, greedy decode, device CER and entropy
(`qea_ocr_tpu_torch/ops/`) against the JAX package on the same numpy
inputs.

The CTC reference is the TPU kernel `ctc_loss_pallas` in interpret mode, so
the infeasible-row clamp (exactly 1e5) is held too. Tolerance for the loss:
rtol 2e-5 — both sides run the same float32 recursion with the same
log-sum-exp guard; only exp/log implementations differ, by an ulp or so per
step over T <= 64 steps. Decode, edit distance, exact-match counts and
per-sample CER must match exactly; a sum of CERs only up to float addition
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qea_ocr_tpu.ops import ctc as jctc
from qea_ocr_tpu.ops import edit_distance as jed
from qea_ocr_tpu.ops import entropy as jent
from qea_ocr_tpu.ops.pallas.ctc_pallas import ctc_loss_pallas
from qea_ocr_tpu_torch.ops import ctc as tctc
from qea_ocr_tpu_torch.ops import edit_distance as ted
from qea_ocr_tpu_torch.ops import entropy as tent
from qea_ocr_tpu_torch.ops.cuda import ctc_cuda

RTOL = 2e-5


def _log_probs(rng, T, B, V):
    x = rng.normal(size=(T, B, V)).astype(np.float32) * 3
    return np.array(jax.nn.log_softmax(jnp.asarray(x), axis=2))


def _labels(rng, B, V, L, lengths):
    labels = np.full((B, L), V, np.int32)
    for i, n in enumerate(lengths):
        labels[i, :n] = rng.integers(1, V, n)
    return labels


def _both(lp, labels, lengths, V):
    ref = np.asarray(ctc_loss_pallas(jnp.asarray(lp), jnp.asarray(labels),
                                     jnp.asarray(lengths), V, 0))
    got = tctc.ctc_loss_samplewise(
        torch.from_numpy(lp), torch.from_numpy(labels),
        torch.from_numpy(lengths), pad_id=V).numpy()
    return got, ref


@pytest.mark.parametrize("seed,T,B,V,L", [
    (0, 31, 5, 95, 100),   # production geometry, B not a multiple of 8
    (1, 12, 13, 20, 6),    # small vocab
    (2, 7, 3, 10, 3),      # tiny T
    (3, 64, 2, 50, 30),    # long sequence
    (4, 31, 1, 95, 12),    # batch of one
])
def test_ctc_matches_pallas_kernel(seed, T, B, V, L):
    rng = np.random.default_rng(seed)
    lp = _log_probs(rng, T, B, V)
    lengths = rng.integers(1, max(1, min(L, (T - 1) // 2)) + 1,
                           B).astype(np.int32)
    got, ref = _both(lp, _labels(rng, B, V, L, lengths), lengths, V)
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_ctc_degenerate_and_long_labels():
    """Empty, single-char, 15 repeats of one char, random 15 and a long
    label that still fits, at L=100 (S = 201 extended labels)."""
    T, V, L = 31, 95, 100
    rng = np.random.default_rng(11)
    lengths = np.asarray([0, 1, 15, 15, 9], np.int32)
    labels = _labels(rng, 5, V, L, lengths)
    labels[2, :15] = 42
    got, ref = _both(_log_probs(rng, T, 5, V), labels, lengths, V)
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_ctc_infeasible_rows_clamp_to_1e5():
    """2L+1 > T or too many repeats: exactly 1e5 in both, feasible rows
    still agree."""
    T, V, L = 10, 20, 8
    rng = np.random.default_rng(13)
    lengths = np.asarray([8, 6, 7], np.int32)
    labels = _labels(rng, 3, V, L, lengths)
    labels[0, :8] = 3                  # 8 repeats need 15 frames > 10
    got, ref = _both(_log_probs(rng, T, 3, V), labels, lengths, V)
    assert got[0] == 1e5 and ref[0] == 1e5
    np.testing.assert_allclose(got[1:], ref[1:], rtol=RTOL)


def test_ctc_zero_length_is_blank_path():
    rng = np.random.default_rng(3)
    lp = _log_probs(rng, 9, 2, 7)
    labels = np.full((2, 4), 7, np.int32)
    got = ctc_cuda.ctc_nll_plain(torch.from_numpy(lp),
                                 torch.from_numpy(labels),
                                 torch.zeros(2, dtype=torch.int32), 7)
    np.testing.assert_allclose(got.numpy(), -lp[:, :, 0].sum(0), rtol=1e-6)


def test_ctc_loss_mean_matches(monkeypatch):
    monkeypatch.setenv("QEA_CTC_IMPL", "pallas")
    rng = np.random.default_rng(5)
    T, B, V, L = 31, 6, 95, 20
    lp = _log_probs(rng, T, B, V)
    lengths = np.asarray([0, 3, 5, 1, 12, 7], np.int32)
    labels = _labels(rng, B, V, L, lengths)
    mask = np.asarray([1, 1, 0, 1, 0, 1], bool)
    for m in (None, mask):
        ref = jctc.ctc_loss_mean(
            jnp.asarray(lp), jnp.asarray(labels), jnp.asarray(lengths),
            pad_id=V, sample_mask=None if m is None else jnp.asarray(m))
        got = tctc.ctc_loss_mean(
            torch.from_numpy(lp), torch.from_numpy(labels),
            torch.from_numpy(lengths), pad_id=V,
            sample_mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)


def _needs(label):
    """Steps a label needs: one a symbol, and a blank between repeats."""
    return len(label) + sum(a == b for a, b in zip(label[:-1], label[1:]))


def _ragged(seed, T=31, B=12, V=20, L=12):
    """Log-probs, labels, lengths and per-row valid steps T_b drawn from a
    numpy seed, with fixed rows: a zero-length label and a one-symbol label
    at T_b = 1, rows at T_b = T, rows that fit T but not their T_b (10
    symbols in 8 steps; three repeats, which need 5, in 4), repeats that
    just fit, and a label longer than T. Returns them with the rows that no
    alignment fits in T_b steps."""
    rng = np.random.default_rng(seed)
    lp = _log_probs(rng, T, B, V)
    fixed = [([], 1), ([4], 1), (list(rng.integers(1, V, 10)), T),
             (list(1 + np.arange(10) % (V - 1)), 8), ([3, 3, 3], 4),
             ([3, 3, 3], 5), ([5, 5, 2, 2], T), (list(rng.integers(1, V, L)),
                                                 T)]
    rows = fixed + [(list(rng.integers(1, V, rng.integers(0, L + 1))),
                     int(rng.integers(1, T + 1)))
                    for _ in range(B - len(fixed))]
    labels = np.full((B, L), V, np.int32)
    lengths = np.array([len(r) for r, _ in rows], np.int32)
    for i, (r, _) in enumerate(rows):
        labels[i, :len(r)] = r
    logit_lengths = np.array([tb for _, tb in rows], np.int32)
    infeasible = np.array([_needs(r) > tb for r, tb in rows])
    assert 0 < infeasible.sum() < B
    return lp, labels, lengths, logit_lengths, infeasible


def _jax_samplewise(lp, labels, lengths, logit_lengths, V):
    return np.asarray(jctc.ctc_loss_samplewise(
        jnp.asarray(lp), jnp.asarray(labels), jnp.asarray(lengths), pad_id=V,
        logit_lengths=jnp.asarray(logit_lengths)))


def _port_samplewise(lp, labels, lengths, logit_lengths, V):
    return tctc.ctc_loss_samplewise(
        torch.from_numpy(lp), torch.from_numpy(labels),
        torch.from_numpy(lengths), pad_id=V,
        logit_lengths=None if logit_lengths is None
        else torch.from_numpy(logit_lengths)).numpy()


@pytest.mark.parametrize("seed,T,V,L", [
    (40, 31, 20, 12),     # the CRNN's T
    (41, 31, 95, 30),     # the production vocabulary
    (42, 9, 7, 10),       # a short sequence, labels longer than T
])
def test_ctc_logit_lengths_match_jax(seed, T, V, L):
    """Rows an alignment fits in T_b steps agree with JAX's
    `ctc_loss_samplewise(logit_lengths=...)` (its optax path) at RTOL; a row
    that none fits is exactly 1e5 in the port and optax's surrogate, at or
    above 1e5, in JAX."""
    lp, labels, lengths, ll, infeasible = _ragged(seed, T=T, V=V, L=L)
    got = _port_samplewise(lp, labels, lengths, ll, V)
    ref = _jax_samplewise(lp, labels, lengths, ll, V)
    assert (got[infeasible] == 1e5).all() and (ref[infeasible] >= 1e5).all()
    assert (got[~infeasible] < 1e5).all()
    np.testing.assert_allclose(got[~infeasible], ref[~infeasible], rtol=RTOL)


@pytest.mark.parametrize("masked", [False, True])
def test_ctc_loss_mean_logit_lengths_match_jax(masked):
    """The mean over the feasible rows, with and without `sample_mask`,
    against JAX's `ctc_loss_mean(logit_lengths=...)` (its infeasible rows'
    surrogate differs from the port's 1e5, so they are masked out here)."""
    lp, labels, lengths, ll, infeasible = _ragged(43)
    keep = ~infeasible
    mask = keep & (np.arange(len(keep)) % 3 != 1) if masked else keep
    V = lp.shape[2]
    ref = jctc.ctc_loss_mean(
        jnp.asarray(lp), jnp.asarray(labels), jnp.asarray(lengths), pad_id=V,
        logit_lengths=jnp.asarray(ll), sample_mask=jnp.asarray(mask))
    got = tctc.ctc_loss_mean(
        torch.from_numpy(lp), torch.from_numpy(labels),
        torch.from_numpy(lengths), pad_id=V,
        logit_lengths=torch.from_numpy(ll), sample_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)


def test_logit_lengths_all_t_is_bitwise_none():
    """Lengths all equal to T give the `None` result bit for bit, loss and
    gradient."""
    lp, labels, lengths, _, _ = _ragged(44)
    T, B, V = lp.shape
    full = np.full(B, T, np.int32)
    assert np.array_equal(_port_samplewise(lp, labels, lengths, full, V),
                          _port_samplewise(lp, labels, lengths, None, V))
    grads = []
    for ll in (None, torch.from_numpy(full)):
        x = torch.from_numpy(lp).requires_grad_()
        tctc.ctc_loss_samplewise(x, torch.from_numpy(labels),
                                 torch.from_numpy(lengths), pad_id=V,
                                 logit_lengths=ll).sum().backward()
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])


def test_logit_lengths_row_equals_the_row_cut_to_its_steps():
    """Each row equals, bit for bit, the same row run alone on its first T_b
    steps with no lengths, and its gradient there too (0 after them)."""
    lp, labels, lengths, ll, _ = _ragged(45)
    V = lp.shape[2]
    x = torch.from_numpy(lp).requires_grad_()
    nll = tctc.ctc_loss_samplewise(x, torch.from_numpy(labels),
                                   torch.from_numpy(lengths), pad_id=V,
                                   logit_lengths=torch.from_numpy(ll))
    nll.sum().backward()
    for b, tb in enumerate(ll):
        xb = torch.from_numpy(lp[:tb, b:b + 1].copy()).requires_grad_()
        alone = tctc.ctc_loss_samplewise(
            xb, torch.from_numpy(labels[b:b + 1]),
            torch.from_numpy(lengths[b:b + 1]), pad_id=V)
        alone.sum().backward()
        assert alone.item() == nll[b].item(), b
        assert torch.equal(xb.grad[:, 0], x.grad[:tb, b]), b
        assert (x.grad[tb:, b] == 0).all(), b


@pytest.mark.parametrize("bad,match", [
    (lambda ll: ll * 0, r"\[1, T"),                   # a length of 0
    (lambda ll: ll + 31, r"\[1, T"),                  # beyond T
    (lambda ll: ll[:, None], "shape"),                # (B, 1)
    (lambda ll: ll.float(), "integer"),               # not an integer
    (lambda ll: ll.to("meta"), "log-probs on"),       # another device
])
def test_logit_lengths_refused(bad, match):
    """What the kernels do not take raises `ValueError` before anything
    runs, on the CPU path and in the kernels' own wrappers (which refuse
    before they look for a GPU)."""
    lp, labels, lengths, ll, _ = _ragged(46)
    args = (torch.from_numpy(lp), torch.from_numpy(labels),
            torch.from_numpy(lengths))
    bad_ll = bad(torch.from_numpy(ll))
    with pytest.raises(ValueError, match=match):
        tctc.ctc_loss_samplewise(*args, pad_id=lp.shape[2],
                                 logit_lengths=bad_ll)
    with pytest.raises(ValueError, match=match):
        ctc_cuda.check_logit_lengths(args[0], bad_ll)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_decode_matches_exactly(seed):
    rng = np.random.default_rng(seed)
    T, B, V = 31, 9, 12
    # few classes and sticky runs: many repeats and blanks to collapse
    ids = rng.integers(0, V, (T, B))
    ids[1::2] = np.where(rng.random((T // 2, B)) < 0.5, ids[::2][:T // 2],
                         ids[1::2])
    scores = rng.normal(size=(T, B, V)).astype(np.float32)
    np.put_along_axis(scores, ids[..., None], 10.0, axis=2)
    ref_dec, ref_len = jctc.greedy_decode(jnp.asarray(scores), pad_id=V)
    dec, ln = tctc.greedy_decode(torch.from_numpy(scores), pad_id=V)
    assert dec.dtype == torch.int32 and ln.dtype == torch.int32
    np.testing.assert_array_equal(dec.numpy(), np.asarray(ref_dec))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(ref_len))


def _label_pairs(rng, B, L1, L2, V=6):
    a = rng.integers(0, V, (B, L1)).astype(np.int32)
    b = rng.integers(0, V, (B, L2)).astype(np.int32)
    a_len = rng.integers(0, L1 + 1, B).astype(np.int32)
    b_len = rng.integers(0, L2 + 1, B).astype(np.int32)
    b[:3, :L1] = a[:3, :min(L1, L2)]            # some exact matches
    b_len[:3] = a_len[:3] = np.minimum(a_len[:3], min(L1, L2))
    return a, a_len, b, b_len


@pytest.mark.parametrize("L1,L2", [(31, 100), (12, 7)])
def test_levenshtein_and_compare_labels_match_exactly(L1, L2):
    rng = np.random.default_rng(L1 + L2)
    a, a_len, b, b_len = _label_pairs(rng, 16, L1, L2)
    mask = rng.random(16) < 0.7
    ta, tal, tb, tbl = map(torch.from_numpy, (a, a_len, b, b_len))
    np.testing.assert_array_equal(
        ted.batched_levenshtein(ta, tal, tb, tbl).numpy(),
        np.asarray(jed.batched_levenshtein(*map(jnp.asarray,
                                                (a, a_len, b, b_len)))))
    for m in (None, mask):
        ref = jed.compare_labels_device(
            *map(jnp.asarray, (a, a_len, b, b_len)),
            mask=None if m is None else jnp.asarray(m))
        got = ted.compare_labels_device(
            ta, tal, tb, tbl, mask=None if m is None else torch.from_numpy(m))
        # count and per-sample CER exact; the CER sum only up to the
        # order in which each framework adds 16 floats
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_entropy_matches():
    rng = np.random.default_rng(9)
    lp = _log_probs(rng, 31, 7, 95)
    ref = jent.mean_sequence_entropy(jnp.asarray(lp))
    got = tent.mean_sequence_entropy(torch.from_numpy(lp))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_cuda_wrapper_validates_before_launch():
    """The kernel wrapper refuses what the kernel does not take, and never
    runs a CPU tensor (the dispatcher sends those to the plain version)."""
    lp = torch.zeros(4, 2, 5)
    lab = torch.zeros(2, 3, dtype=torch.int32)
    ln = torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        ctc_cuda.ctc_nll_cuda(lp.double(), lab, ln, 5)
    with pytest.raises(ValueError):
        ctc_cuda.ctc_nll_cuda(lp, torch.zeros(2, 600, dtype=torch.int32),
                              ln, 5)
    with pytest.raises(ValueError):
        ctc_cuda.ctc_nll_cuda(lp, lab, ln, 5)          # CPU tensors
    # a tensor that requires grad is checked like any other: the wrapper has
    # no quiet detour for it (the gradient is `ctc_nll`'s kernel pair)
    with pytest.raises(ValueError):
        ctc_cuda.ctc_nll_cuda(lp.requires_grad_(), lab, ln, 5)
    with pytest.raises(ValueError):
        ctc_cuda.ctc_grad_cuda(lp.detach(), lab, ln, torch.zeros(2, 4, 7),
                               torch.zeros(2), torch.ones(2), 5)  # CPU tensors


@pytest.mark.parametrize("T,L,V", [
    (120, 100, 95),    # a long sequence at the main path's L and V
    (16, 3, 4096),     # a large vocabulary
    (200, 511, 20),    # the longest labels, and a long sequence
])
def test_cuda_backward_limits_raise_before_launch(T, L, V):
    """The backward kernel's limit (its row's shared memory) is checked
    before the device, so it raises on CPU tensors too, for the backward and
    for the forward when it is asked for the backward's alpha; nothing is
    launched. Without alpha the forward takes such shapes (it raises here
    only for the device)."""
    assert ctc_cuda.grad_smem_bytes(T, V, L) > ctc_cuda.GRAD_MAX_SMEM
    assert ctc_cuda.grad_smem_bytes(31, 95, 100) < ctc_cuda.GRAD_MAX_SMEM / 3
    lp = torch.zeros(T, 2, V)
    lab = torch.zeros(2, L, dtype=torch.int32)
    ln = torch.ones(2, dtype=torch.int32)
    counts = (ctc_cuda.launches, ctc_cuda.bwd_launches)
    with pytest.raises(ValueError, match="backward kernel takes"):
        ctc_cuda.ctc_grad_cuda(lp, lab, ln, torch.zeros(2, T, 2 * L + 1),
                               torch.zeros(2), torch.ones(2), V)
    with pytest.raises(ValueError, match="backward kernel takes"):
        ctc_cuda.ctc_nll_cuda(lp, lab, ln, V, want_alpha=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ctc_cuda.ctc_nll_cuda(lp, lab, ln, V)
    assert (ctc_cuda.launches, ctc_cuda.bwd_launches) == counts


@pytest.mark.parametrize("seed,T,L,V", [
    (30, 31, 100, 95),    # the main path: band 63 of S = 201
    (31, 38, 100, 95),    # band 77
    (32, 7, 3, 6),        # S = 7 < 2T+1: the band is all of S
    (33, 5, 12, 8),       # a band of 11 of S = 25
])
def test_alpha_band_holds_every_reachable_position(seed, T, L, V):
    """The kernels work on the band s < min(2L+1, 2T+1) alone. Over the full
    S, alpha at every s at or above it stays at or below the -5e29 cut-off
    at every step. The recursion over the band alone (the labels cut to
    min(L, T) symbols) gives the same alpha there and the same NLL bit for
    bit: a row longer than the band scores 1e5 either way."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, 6, V)).astype(np.float32) * 3
    lp = torch.log_softmax(torch.from_numpy(x), dim=2)
    labels = np.full((6, L), V, np.int32)
    rows = [[],                                      # empty label
            rng.integers(1, V, L),                   # full length
            [1] * min(20, L),                        # 20 repeats
            [2] * min(10, L),                        # 10 repeats
            rng.integers(1, V, min(T - 1, L)),       # the band's last
            1 + np.arange(min(15, L)) % (V - 1)]     # no repeat
    lengths = np.array([len(r) for r in rows], np.int32)
    for i, r in enumerate(rows):
        labels[i, :len(r)] = r
    labels, lengths = torch.from_numpy(labels), torch.from_numpy(lengths)

    nll, alpha = ctc_cuda._alpha_plain(lp, labels, lengths, V, 0)
    band = min(2 * L + 1, 2 * T + 1)
    assert bool((alpha[:, :, band:] <= -5e29).all())
    band_nll, band_alpha = ctc_cuda._alpha_plain(
        lp, labels[:, :min(L, T)].contiguous(), lengths, V, 0)
    assert band_alpha.shape[2] == band
    assert torch.equal(band_alpha, alpha[:, :, :band])
    assert torch.equal(band_nll, nll)
    assert bool((nll[lengths > T] == 1e5).all())
    n = ctc_cuda.band_threads(T, L)
    assert n % 32 == 0 and band <= n < band + 32


def test_band_threads():
    assert ctc_cuda.band_threads(31, 100) == 64
    assert ctc_cuda.band_threads(38, 100) == 96
    assert ctc_cuda.band_threads(16, 3) == 32
    assert ctc_cuda.band_threads(200, 511) == 416
