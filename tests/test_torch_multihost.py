"""The port's multi-process layer (`qea_ocr_tpu_torch/parallel/multihost.py`):
its host functions against the JAX package's, the process-group set-up
from the environment, and the patch trainer for an epoch on 2 Gloo ranks
(the assertions of `tests/_mh_trainer_worker.py`), with `data_parallel`
and with `tensor_parallel=2`.

The trainer world runs once (`_torch_dp_worker.py`, mode `mh`, about
15 s): 8 training documents of 3 strips in global batches of 8 (4 a
rank), rangeCER 0.5, 2 OCR rounds, 3 validation documents (rank 1's slice
of the only window is empty).
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_world import ROOT, case, free_port, run_world
from qea_ocr_tpu.data import pipeline as j_pipeline
from qea_ocr_tpu.parallel import multihost as j_mh
from qea_ocr_tpu.utils.io import resolve_side_shard as j_resolve
from qea_ocr_tpu_torch.data import pipeline as t_pipeline
from qea_ocr_tpu_torch.parallel import multihost as t_mh
from qea_ocr_tpu_torch.utils.io import resolve_side_shard as t_resolve

TRAIN_DOCS, VAL_DOCS, STRIPS, PROP, INNER = 8, 3, 3, 0.5, 2


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


# ------------------------------------------------------------ host functions
def test_shard_indices_partition():
    """Rank shards are disjoint, equal-sized, concatenate (in rank order,
    per window) back to the global step sequence, and equal the JAX
    package's."""
    indices = np.random.default_rng(0).permutation(103)
    D, pc = 8, 4
    dl = t_mh.local_batch_size(D, pc)
    shards = [t_mh.shard_indices_for_host(indices, D, p, pc)
              for p in range(pc)]
    for p, s in enumerate(shards):
        np.testing.assert_array_equal(
            s, j_mh.shard_indices_for_host(indices, D, p, pc))
    steps = len(indices) // D
    assert all(len(s) == steps * dl for s in shards)
    rebuilt = np.concatenate(
        [np.concatenate([s[k * dl:(k + 1) * dl] for s in shards])
         for k in range(steps)])
    np.testing.assert_array_equal(rebuilt, indices[:steps * D])


def test_local_batch_size_divisibility():
    assert t_mh.local_batch_size(12, 4) == j_mh.local_batch_size(12, 4) == 3
    with pytest.raises(ValueError):
        t_mh.local_batch_size(10, 4)


def test_batch_iterator_host_shard_matches_global():
    """Interleaving per-rank iterator outputs reproduces the unsharded
    global batches, and each rank's stream equals the JAX package's."""
    ds = _Range(50)
    D, pc = 8, 2
    collate = lambda xs: np.asarray(xs)  # noqa: E731
    global_batches = list(t_pipeline.batch_iterator(
        ds, D, collate, seed=3, epoch=2, drop_last=True))
    streams = [list(t_pipeline.batch_iterator(
        ds, D, collate, seed=3, epoch=2, host_shard=(p, pc)))
        for p in range(pc)]
    for p in range(pc):
        want = list(j_pipeline.batch_iterator(
            ds, D, collate, seed=3, epoch=2, host_shard=(p, pc)))
        assert len(streams[p]) == len(want) == len(global_batches)
        for got, w in zip(streams[p], want):
            np.testing.assert_array_equal(got, w)
    for k, gb in enumerate(global_batches):
        np.testing.assert_array_equal(
            np.concatenate([streams[p][k] for p in range(pc)]), gb)


@pytest.mark.parametrize("n,pc", [(10, 1), (10, 3), (7, 2), (2, 4)])
def test_pinned_subset(n, pc):
    idx = np.random.default_rng(n).permutation(n)
    parts = [t_mh.pinned_subset(idx, p, pc) for p in range(pc)]
    for p in range(pc):
        np.testing.assert_array_equal(parts[p],
                                      j_mh.pinned_subset(idx, p, pc))
    assert len({len(x) for x in parts}) == 1
    assert len(np.unique(np.concatenate(parts))) == sum(map(len, parts))


def test_resolve_side_shard(tmp_path):
    path = str(tmp_path / "tracked_labels_current.json")
    (tmp_path / "tracked_labels_current.p1.json").write_text("{}")
    for rank in (0, 1):
        assert t_resolve(path, rank) == j_resolve(path, rank)
    assert t_resolve(path, 1).endswith(".p1.json")
    assert t_resolve(path, 0) == path


def test_without_a_group_the_collectives_are_identities():
    import torch
    assert t_mh.process_shard() == (0, 1)
    np.testing.assert_array_equal(t_mh.process_sum([3, 4]), [3, 4])
    x = torch.arange(6.0)
    with t_mh.data_group(None):
        assert t_mh.global_count(x) is x and t_mh.gather_rows(x) is x
        assert t_mh.global_mean(x) == x.mean()
    assert t_mh.current_group() is None


def test_cli_distributed_env_glue():
    """`QEA_DISTRIBUTED=1` with `QEA_COORDINATOR` / `QEA_NUM_PROCESSES` /
    `QEA_PROCESS_ID` makes a Gloo group for `--device cpu`; a second call
    keeps it; asking it for a CUDA device raises; torchrun's `RANK` /
    `WORLD_SIZE` / `MASTER_ADDR` / `MASTER_PORT` make one too
    (`tests/test_multihost_procs.py::test_cli_distributed_env_glue`)."""
    code = (
        "import os\n"
        "import torch.distributed as dist\n"
        "from qea_ocr_tpu_torch.parallel.multihost import "
        "maybe_init_distributed, process_shard\n"
        "assert maybe_init_distributed('cpu')\n"
        "assert dist.get_backend() == 'gloo' and process_shard() == (0, 1)\n"
        "assert maybe_init_distributed('cpu')\n"
        "try:\n"
        "    maybe_init_distributed('cuda')\n"
        "    raise SystemExit('a cuda run took the gloo group')\n"
        "except RuntimeError:\n"
        "    pass\n"
        "dist.destroy_process_group()\n"
        "for k in ('QEA_DISTRIBUTED', 'QEA_COORDINATOR'):\n"
        "    del os.environ[k]\n"
        "assert not maybe_init_distributed('cpu')\n"
        "os.environ.update(RANK='0', WORLD_SIZE='1', "
        "MASTER_ADDR='127.0.0.1', MASTER_PORT=os.environ['PORT2'])\n"
        "assert maybe_init_distributed('cpu') and dist.get_world_size() == 1\n"
        "dist.destroy_process_group()\n"
        "print('DIST_INIT_OK')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(QEA_DISTRIBUTED="1", QEA_COORDINATOR=f"127.0.0.1:{free_port()}",
               QEA_NUM_PROCESSES="1", QEA_PROCESS_ID="0",
               PORT2=str(free_port()), PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         text=True, timeout=120, capture_output=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "DIST_INIT_OK" in out.stdout


# ------------------------------------------------------ the trainer world
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world("mh", 2, tmp_path_factory.mktemp("mh"))


def test_pinned_subsets_and_local_batches(world):
    r0, r1 = case(world, "patch_trainer_dp")
    assert (r0["pc"], r0["pi"], r1["pi"]) == (2, 0, 1)
    assert r0["dl"] == r1["dl"] == TRAIN_DOCS // 2
    assert r0["subset"] == [0, 2, 4, 6] and r1["subset"] == [1, 3, 5, 7]


def test_per_rank_ledger(world):
    """Each rank queried only its own documents: INNER rounds x
    ceil(3 x (1 - 0.5)) = 2 strips x 4 documents in training; in
    validation rank 0 reads the 3 documents' 9 strips and rank 1's slice
    is empty."""
    per_doc = math.ceil(STRIPS * (1 - PROP))
    local_train = INNER * per_doc * (TRAIN_DOCS // 2)
    r0, r1 = case(world, "patch_trainer_dp")
    assert r0["calls"] == local_train + VAL_DOCS * STRIPS
    assert r1["calls"] == local_train


def test_global_ledger_in_metrics(world):
    per_doc = math.ceil(STRIPS * (1 - PROP))
    r0, _ = case(world, "patch_trainer_dp")
    rec = r0["record"]
    assert rec["Black-Box Calls"] == INNER * per_doc * TRAIN_DOCS
    assert rec["Train + Val BB Calls"] == (
        INNER * per_doc * TRAIN_DOCS + VAL_DOCS * STRIPS)
    assert math.isfinite(rec["train_loss"]) and math.isfinite(rec["val_loss"])


def test_same_result_and_state_on_both_ranks(world):
    r0, r1 = case(world, "patch_trainer_dp")
    assert r0["best"] == r1["best"]
    assert r0["same"] and r1["same"]
    assert any(n.startswith("Prep_model_0_") for n in r0["ckpts"])


def test_side_state_sharded_per_rank(world):
    for r, res in enumerate(case(world, "patch_trainer_dp")):
        assert f"tracked_labels_current.p{r}.json" in res["side"]


def test_tensor_parallel_queries_each_strip_once(world):
    """`tensor_parallel=2` on 2 ranks: one model group, both ranks on the
    same documents; rank 0 queries and shares the labels, so the ledger
    equals the data-parallel run's (which equals single-process's)."""
    dp0, _ = case(world, "patch_trainer_dp")
    t0, t1 = case(world, "patch_trainer_tp")
    for k in ("Black-Box Calls", "Train + Val BB Calls",
              "Total Black-Box Calls"):
        assert t0["record"][k] == dp0["record"][k], k
    assert t1["calls"] == 0
    assert t0["calls"] == dp0["record"]["Train + Val BB Calls"]
    assert t0["pc"] == 1 and t0["subset"] == list(range(TRAIN_DOCS))
    assert t0["best"] == t1["best"]


def test_tensor_parallel_state(world):
    """Parameters are stored as shards, the twin holds the grad model's
    tensors, the tables are the same on both ranks, and the gathered
    checkpoint loads into plain single-process models."""
    t0, t1 = case(world, "patch_trainer_tp")
    assert t0["dtensors"] == t1["dtensors"] > 0
    assert t0["twin_shares"] and t1["twin_shares"]
    assert t0["same"] and t1["same"]
    assert t0["plain_forward_finite"]
