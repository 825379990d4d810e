"""The port's tensor-parallel layer (`qea_ocr_tpu_torch/parallel/tp.py`):
`tp_spec` against the JAX package's rule, and `put_tp` on a 2x2
(data x model) mesh of 4 Gloo ranks with the two-phase step against the
single-process step on the union batch (`tests/test_parallel.py:102-125`
for JAX), losses rel 1e-5 and parameters abs 1e-5 as in
`test_torch_dp.py`.

The world runs once (`_torch_dp_worker.py`, mode `tp4`, about 10 s).
"""

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from _torch_world import case, run_world
from qea_ocr_tpu.parallel.tp import tp_spec as j_tp_spec
from qea_ocr_tpu_torch.parallel.tp import tp_spec


def test_tp_spec_rules():
    n_model = 2
    assert tp_spec(np.zeros((3, 3, 16, 32)), n_model) == Shard(3)
    assert tp_spec(np.zeros((128, 64)), n_model) == Shard(1)
    # odd vocabulary head, scalar, a vector below min_shard: replicated
    assert isinstance(tp_spec(np.zeros((128, 95)), n_model), Replicate)
    assert isinstance(tp_spec(np.float32(1.0), n_model), Replicate)
    assert isinstance(tp_spec(np.zeros((2,)), n_model, min_shard=2),
                      Replicate)
    assert tp_spec(np.zeros((64,)), n_model) == Shard(0)


@pytest.mark.parametrize("n_model", [1, 2, 3, 4])
def test_tp_spec_is_the_jax_rule(n_model):
    """On the same shapes the port shards exactly where JAX does, and on
    the same (trailing) axis."""
    shapes = [(), (2,), (3,), (8,), (95,), (128, 95), (512, 512, 2, 2),
              (64, 1, 3, 3), (64, 512), (3, 3, 16, 32), (6,), (12, 4)]
    for shape in shapes:
        x = np.zeros(shape)
        want = j_tp_spec(x, n_model)
        got = tp_spec(x, n_model)
        if want == P():
            assert isinstance(got, Replicate), shape
        else:
            assert want[-1] == "model" and got == Shard(len(shape) - 1), shape


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world("tp4", 4, tmp_path_factory.mktemp("tp4"))


def test_two_phase_step_on_2d_mesh_matches_single_process(world):
    r0 = case(world, "tp_step")[0]
    assert r0["loss_b_rel"] <= 1e-5 and r0["loss_a_rel"] <= 1e-5
    for key in ("unet_params", "crnn_params"):
        worst, held, name = r0[key]
        assert worst <= 1e-5 and held > 0.2, (key, worst, name)
    assert r0["cer_abs"] <= 1e-6 and r0["ent_abs"] <= 1e-6


def test_put_tp_distributes_large_kernels(world):
    """Every parameter the rule shards is a `DTensor` sharded on its
    trailing axis over `model`; the rest stay plain (replicated); the LSTM
    and linear kernels are among the sharded."""
    for res in case(world, "tp_step"):
        placements = res["placements"]
        for name, (shape, shardable, sharded) in placements.items():
            assert shardable == sharded, (name, shape)
        assert placements["lstm.weight_ih_l0"][2]
        assert placements["linear.weight"][2]
        assert not placements["linear.bias"][2]     # 95 does not divide


def test_every_rank_ends_with_the_same_parameters_and_tables(world):
    assert all(r["same"] for r in case(world, "tp_step"))
