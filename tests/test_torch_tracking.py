"""The port's label history and loss-weight generators
(`qea_ocr_tpu_torch/tracking/`, `models/attention.py`) against the JAX
package's on seeded histories: the history's arrays and JSON equal, weights
to 1e-5 (float32 sums in another order)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qea_ocr_tpu.models import HistoryAttention as JAttention
from qea_ocr_tpu.tracking import history as jh
from qea_ocr_tpu.tracking import weights as jw
from qea_ocr_tpu_torch.models.attention import HistoryAttention
from qea_ocr_tpu_torch.tools.convert import attention_state_dict
from qea_ocr_tpu_torch.tracking import history as th
from qea_ocr_tpu_torch.tracking import weights as tw
from qea_ocr_tpu_torch.utils.charmap import CharMap

import _torch_parity  # noqa: F401  (one torch thread)

N, W = 12, 3
WORDS = ["TOTAL", "T0TAL", "TOTAL", "CASH", "12.50", "", "x", "RECEIPT",
         "RECElPT", "THANK YOU", "7", "TOTAL 12.50"]


def _filled(cls, rounds=4, seed=0):
    """A history after `rounds` of seeded additions to a random subset."""
    cm = CharMap.default()
    hist = cls(N, W)
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        ids = rng.permutation(N)[:rng.integers(1, N)]
        texts = [WORDS[i] for i in rng.integers(0, len(WORDS), len(ids))]
        labels, lengths = cm.encode(texts)
        hist.add(ids, labels, lengths, texts)
    return hist


def test_label_history_equal(tmp_path):
    j, t = _filled(jh.LabelHistory), _filled(th.LabelHistory)
    for name in ("labels", "lengths", "counts"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    ids = np.asarray([0, 5, 11, 5])
    for a, b in zip(t.gather(ids), j.gather(ids)):
        np.testing.assert_array_equal(a, b)
    id_to_name = {i: f"strip{i}" for i in range(N)}
    assert t.to_json_dict(id_to_name) == j.to_json_dict(id_to_name)
    t.save_json(str(tmp_path / "t.json"), id_to_name)
    j.save_json(str(tmp_path / "j.json"), id_to_name)
    assert json.loads((tmp_path / "t.json").read_text()) \
        == json.loads((tmp_path / "j.json").read_text())
    # resume: each package loads the other's file
    name_to_id = {v: k for k, v in id_to_name.items()}
    t2, j2 = th.LabelHistory(N, W), jh.LabelHistory(N, W)
    t2.load_json(str(tmp_path / "j.json"), name_to_id)
    j2.load_json(str(tmp_path / "t.json"), name_to_id)
    for name in ("labels", "lengths", "counts"):
        np.testing.assert_array_equal(getattr(t2, name), getattr(j2, name))
    for a, b in zip(t2.gather(ids), t.gather(ids)):
        np.testing.assert_array_equal(a, b)     # the window survives


def test_decaying_weights_equal():
    for decay, w in ((0.7, 1), (0.7, 3), (0.25, 5)):
        np.testing.assert_allclose(
            tw.decaying_weights(decay, w).numpy(),
            np.asarray(jw.decaying_weights(decay, w)), rtol=1e-7)


def test_levenshtein_weights_match():
    hist = _filled(th.LabelHistory, rounds=6, seed=1)
    labs, lens, valid = hist.gather(np.arange(N))
    assert valid.any() and not valid.all()
    want = np.asarray(jw.levenshtein_weights(
        jnp.asarray(labs), jnp.asarray(lens), jnp.asarray(valid)))
    got = tw.levenshtein_weights(torch.from_numpy(labs),
                                 torch.from_numpy(lens),
                                 torch.from_numpy(valid))
    assert got.shape == (N, W + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert (got[:, 0] == 1).all()
    assert (got[:, 1:][~torch.from_numpy(valid)] == 0).all()
    assert float(got[:, 1:].max()) <= 0.5


@pytest.mark.parametrize("activation", ["sigmoid", "softmax", "relu"])
def test_attention_weights_match(activation):
    cm = CharMap.default()
    hist = _filled(th.LabelHistory, rounds=6, seed=2)
    labs, _, valid = hist.gather(np.arange(N))
    jmodel = JAttention(char_vocab_size=cm.vocab_size, emb_size=16,
                        query_dim=8, window_size=W, activation=activation)
    variables = jmodel.init(jax.random.PRNGKey(3),
                            jnp.zeros((1, W, cm.max_len), jnp.int32))
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.default_rng(4)      # flax starts these at zero
    variables["params"]["positional_encodings"] = rng.normal(
        0, 0.5, (W, 16)).astype(np.float32)
    variables["params"]["loss_coef_layer"]["bias"] = rng.normal(
        0, 0.5, (1,)).astype(np.float32)
    variables["params"]["Wq"]["bias"] = rng.normal(
        0, 0.5, (8,)).astype(np.float32)
    want = np.asarray(jw.attention_weights(
        jmodel.apply, variables, jnp.asarray(labs), jnp.asarray(valid)))

    model = HistoryAttention(cm.vocab_size, emb_size=16, query_dim=8,
                             window_size=W, activation=activation)
    model.load_state_dict(attention_state_dict(variables), strict=True)
    assert float(model.embedding[cm.pad_id].abs().max()) == 0.0
    assert "embedding" not in dict(model.named_parameters())    # frozen
    got = tw.attention_weights(model, torch.from_numpy(labs),
                               torch.from_numpy(valid))
    assert got.shape == (N, W + 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_attention_model_is_seeded_and_checks_its_activation():
    a = HistoryAttention(95, 16, 8, 2, generator=torch.Generator().manual_seed(1))
    b = HistoryAttention(95, 16, 8, 2, generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert float(a.embedding[95].abs().max()) == 0.0
    trained = HistoryAttention(95, 16, 8, 2, is_emb_train=True)
    assert "embedding" in dict(trained.named_parameters())
    with pytest.raises(ValueError):
        HistoryAttention(95, activation="tanh")


def test_weightgenerator_factory():
    for name in jw.WEIGHTGEN_METHODS:
        assert tw.weightgenerator_factory(name) \
            == jw.weightgenerator_factory(name)
    assert tw.WEIGHTGEN_METHODS == jw.WEIGHTGEN_METHODS
    with pytest.raises(KeyError):
        tw.weightgenerator_factory("median")
