"""Port parity: UNet and CRNN (`qea_ocr_tpu_torch/models/`) against the flax
models under the same weights, carried across with
`qea_ocr_tpu_torch/tools/convert.py`.

Both sides run in float32 (`compute_dtype` float32) so the comparison is of
the algorithm, not of bfloat16 rounding: tolerance 1e-6 absolute on the
UNet's sigmoid output and 1e-5 on the CRNN's log-probs (float32 conv / LSTM
sums in a different order; measured 6e-8 and 5e-7). The bfloat16 policy is
held to a looser bound, stated in its tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flax_variables_like
from qea_ocr_tpu.models import CRNN as JCRNN
from qea_ocr_tpu.models import UNet as JUNet
from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.tools.convert import (
    crnn_state_dict, load_state_dict_file, unet_state_dict)


def _port_dtype(compute):
    return torch.float32 if compute == jnp.float32 else torch.bfloat16


@pytest.fixture(scope="module")
def unet_vars():
    """Random flax UNet(4) variables with perturbed batch norms (parameters
    do not depend on the compute dtype, so one set serves both policies)."""
    return flax_variables_like(
        JUNet(init_features=4),
        UNet(init_features=4, generator=torch.Generator().manual_seed(0)),
        (1, 1, 16, 16), 0)


@pytest.fixture(scope="module")
def crnn_vars():
    return flax_variables_like(
        JCRNN(vocab_size=95, lstm_hidden=16),
        CRNN(95, lstm_hidden=16, generator=torch.Generator().manual_seed(1)),
        (1, 1, 32, 128), 1)


def _run_unet(v, compute):
    tm = UNet(init_features=4, compute_dtype=_port_dtype(compute))
    tm.load_state_dict(unet_state_dict(v), strict=True)
    x = np.random.default_rng(2).random((2, 1, 32, 64), dtype=np.float32)
    ref = np.asarray(JUNet(init_features=4, compute_dtype=compute).apply(
        v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 1, 32, 64)
    return got.numpy(), ref


def _run_crnn(v, compute):
    tm = CRNN(95, lstm_hidden=16, compute_dtype=_port_dtype(compute))
    tm.load_state_dict(crnn_state_dict(v), strict=True)
    x = np.random.default_rng(3).random((2, 1, 32, 128), dtype=np.float32)
    ref = np.asarray(JCRNN(vocab_size=95, lstm_hidden=16,
                           compute_dtype=compute).apply(
        v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (31, 2, 95)
    return got.numpy(), ref


def test_unet_matches_flax_f32(unet_vars):
    got, ref = _run_unet(unet_vars, jnp.float32)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_crnn_matches_flax_f32(crnn_vars):
    got, ref = _run_crnn(crnn_vars, jnp.float32)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_unet_bf16_policy_matches_flax_bf16(unet_vars):
    """bfloat16 convs on both sides; each framework rounds at its own
    places, so agreement is to bfloat16 precision (1e-2 absolute on the
    sigmoid output)."""
    got, ref = _run_unet(unet_vars, jnp.bfloat16)
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0)


def test_crnn_bf16_policy_matches_flax_bf16(crnn_vars):
    """bfloat16 convs, LSTM matmuls and gates on both sides: 3e-2 absolute
    on the log-probs (bfloat16 rounding compounded over 7 convs and 31
    LSTM steps of 2 layers)."""
    got, ref = _run_crnn(crnn_vars, jnp.bfloat16)
    np.testing.assert_allclose(got, ref, atol=3e-2, rtol=0)


def test_state_dict_file_round_trip(unet_vars, tmp_path):
    """`load_state_dict_file` reads what `torch.save` of a converted
    state_dict wrote, with weights_only loading."""
    sd = unet_state_dict(unet_vars)
    path = tmp_path / "prep.pt"
    torch.save(sd, path)
    fresh = UNet(init_features=4)
    fresh.load_state_dict(load_state_dict_file(str(path)), strict=True)
    for k, t in fresh.state_dict().items():
        assert torch.equal(sd[k], t), k
