"""The port's query-budget selection (`qea_ocr_tpu_torch/selection/`) against
the JAX package's on the same seeded estimates and validity masks: ranks,
masks and counts must be *equal*.

`jax.random` streams do not exist in torch, so both sides are fed the same
uniform numbers: the port takes them as `noise`; on the JAX side
`jax.random.split` and `jax.random.uniform` are patched (inside the samplers
module only) so that document d draws row d of the same table. The JAX
functions run un-jitted (`select_batch.__wrapped__`), so no cached trace of
the unpatched function can answer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qea_ocr_tpu.selection import api as japi
from qea_ocr_tpu.selection import samplers as js
from qea_ocr_tpu_torch.selection import api as tapi
from qea_ocr_tpu_torch.selection import samplers as ts

import _torch_parity  # noqa: F401  (one torch thread)

D, S = 5, 9


def _world(seed, sentinel=False):
    rng = np.random.default_rng(seed)
    est = rng.random((D, S)).astype(np.float32)
    est[1, 2] = est[1, 5]                       # a tie
    est[2] = 0.5                                # a constant document
    valid = rng.random((D, S)) > 0.3
    valid[3] = False                            # a padding document
    valid[4] = True
    if sentinel:
        # estimates next to the 100.0 sentinel: a claimed slot is claimed
        # again, which shrinks the picked set
        est[4] = np.linspace(99.0, 101.0, S).astype(np.float32)
    noise = rng.random((D, S)).astype(np.float32)
    return est, valid, noise


@pytest.fixture
def jax_noise(monkeypatch):
    """Make the JAX samplers draw row d of a given table for document d."""
    table = {}

    class _Random:
        @staticmethod
        def split(key, n):
            return jnp.stack([jnp.zeros(n, jnp.uint32),
                              jnp.arange(n, dtype=jnp.uint32)], axis=1)

        @staticmethod
        def uniform(key, shape):
            row = table["noise"][key[1]]
            assert tuple(shape) == row.shape
            return row

    class _Jax:
        random = _Random
        vmap = staticmethod(js.jax.vmap)
        lax = js.jax.lax

    monkeypatch.setattr(js, "jax", _Jax)

    def use(noise):
        table["noise"] = jnp.asarray(noise)
    return use


def _jax_ranks(kernel, est, valid):
    keys = js.jax.random.split(None, D)
    return np.asarray(js.jax.vmap(kernel)(keys, jnp.asarray(est),
                                          jnp.asarray(valid)))


@pytest.mark.parametrize("method", ["random", "topKCER", "rangeCER",
                                    "uniformEntropy"])
@pytest.mark.parametrize("sentinel", [False, True])
def test_rank_functions_equal(method, sentinel, jax_noise):
    est, valid, noise = _world(1, sentinel)
    jax_noise(noise)
    want = _jax_ranks(js.RANK_KERNELS[method], est, valid)
    got = ts.RANK_KERNELS[method](None, torch.from_numpy(est),
                                  torch.from_numpy(valid),
                                  torch.from_numpy(noise))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # one document alone gives its row of the batch
    alone = ts.RANK_KERNELS[method](None, torch.from_numpy(est[1]),
                                    torch.from_numpy(valid[1]),
                                    torch.from_numpy(noise[1]))
    np.testing.assert_array_equal(alone.numpy(), want[1])


@pytest.mark.parametrize("method", ["random", "topKCER", "rangeCER"])
@pytest.mark.parametrize("prop", [0.0, 0.25, 0.5, 0.9])
def test_select_batch_equal(method, prop, jax_noise):
    est, valid, noise = _world(2)
    jax_noise(noise)
    want_mask, want_k = js.select_batch.__wrapped__(
        method, None, jnp.asarray(est), jnp.asarray(valid), prop)
    mask, k = ts.select_batch(method, None, torch.from_numpy(est),
                              torch.from_numpy(valid), prop,
                              noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(k.numpy(), np.asarray(want_k))
    n_valid = valid.sum(1)
    np.testing.assert_array_equal(
        k.numpy(), np.minimum(np.maximum(1, np.ceil(
            n_valid * (1 - prop))), n_valid).astype(np.int32))
    assert not (mask.numpy() & ~valid).any()
    np.testing.assert_array_equal(mask.numpy().sum(1), k.numpy())


def test_range_selection_under_budget_next_to_the_sentinel(jax_noise):
    """The ledger's edge case: with estimates next to 100.0 a point re-claims
    a claimed slot, so the mask holds fewer than k strips (where the
    reference re-queries the same strip). Both packages agree on it; real
    CERs in [0, 1] never get there."""
    est, valid, noise = _world(3, sentinel=True)
    noise[4] = np.linspace(0.0, 1.0, S, endpoint=False)[::-1]
    jax_noise(noise)
    want_mask, want_k = js.select_batch.__wrapped__(
        "rangeCER", None, jnp.asarray(est), jnp.asarray(valid), 0.0)
    mask, k = ts.select_batch("rangeCER", None, torch.from_numpy(est),
                              torch.from_numpy(valid), 0.0,
                              noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert int(mask[4].sum()) < int(k[4]) == S


def test_generator_draws_are_seeded_and_needed():
    est, valid, _ = _world(4)
    e, v = torch.from_numpy(est), torch.from_numpy(valid)
    a = ts.select_batch("random", torch.Generator().manual_seed(7), e, v, 0.5)
    b = ts.select_batch("random", torch.Generator().manual_seed(7), e, v, 0.5)
    c = ts.select_batch("random", torch.Generator().manual_seed(8), e, v, 0.5)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    with pytest.raises(ValueError, match="Generator"):
        ts.select_batch("rangeCER", None, e, v, 0.5)
    ts.select_batch("topKCER", None, e, v, 0.5)      # draws nothing


def test_membership_and_global_selectors_equal():
    rng = np.random.default_rng(5)
    cers = rng.random(40).astype(np.float32)
    ids = rng.integers(0, 40, (D, S)).astype(np.int32)
    for name in ("uniformCERglobal", "randomglobal"):
        for num in (1, 7, 40, 55):
            want = js.GLOBAL_METHODS[name](np.random.default_rng(num), cers,
                                           num)
            got = ts.GLOBAL_METHODS[name](np.random.default_rng(num), cers,
                                          num)
            np.testing.assert_array_equal(got, want)
            assert got.sum() <= min(num, 40)
        np.testing.assert_array_equal(
            ts.membership_mask(torch.from_numpy(ids),
                               torch.from_numpy(got)).numpy(),
            np.asarray(js.membership_mask(jnp.asarray(ids),
                                          jnp.asarray(want))))
    assert ts.ALL_METHODS == js.ALL_METHODS
    for m in (None, "", "random", "randomglobal", "uniformCERglobal"):
        assert ts.is_global(m) == js.is_global(m)


@pytest.mark.parametrize("method", ["random", "topKCER", "rangeCER",
                                    "uniformEntropy", "uniformCERglobal",
                                    "randomglobal"])
def test_sampler_classes_equal(method):
    """The reference-shaped classes: the same factory keys, and the same
    picks where the pick is made on the host (numpy on both sides)."""
    rng = np.random.default_rng(6)
    names = [f"s{i}" for i in range(12)]
    cers = {n: float(c) for n, c in zip(names, rng.random(12))}
    images = rng.random((12, 4, 8)).astype(np.float32)
    labels = [n.upper() for n in names]
    jcls, tcls = (japi.datasampler_factory(method),
                  tapi.datasampler_factory(method))
    assert jcls.__name__ == tcls.__name__ and jcls.method == tcls.method
    if method == "uniformEntropy":
        j, t = jcls(entropies=cers), tcls(entropies=cers)
    elif "global" in method:
        j, t = jcls(cers, num_samples=5), tcls(cers, num_samples=5)
    else:
        j, t = jcls(cers), tcls(cers)
    j.seed(3), t.seed(3)
    if "global" in method:
        j.select_samples(), t.select_samples()
        assert j.selected_samplenames == t.selected_samplenames
    ji, jl, jidx = j.query(images, labels, 5, names)
    ti, tl, tidx = t.query(images, labels, 5, names)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(ti, ji)
    assert tl == jl
    j.update_cer([0.25, 0.5], names[:2]), t.update_cer([0.25, 0.5], names[:2])
    assert j.cers == t.cers and j.all_cers == t.all_cers


def test_base_sampler_goes_through_select_batch():
    s = tapi.DataSampler({"a": 0.1, "b": 0.9, "c": 0.5, "d": 0.3})
    s.method = "topKCER"
    _, labels, idx = s.query(np.zeros((4, 2, 2)), list("wxyz"), 2,
                             list("abcd"))
    assert sorted(idx.tolist()) == [1, 2] and sorted(labels) == ["x", "y"]
