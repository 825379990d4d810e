"""The port's data-parallel steps on 2 Gloo ranks against its
single-process step on the union batch (`qea_ocr_tpu_torch/parallel/`,
`make_steps(group=...)`); the single-process steps are held to the JAX
package's in `test_torch_train_step.py`, `test_torch_crnn_trainer.py` and
`test_torch_area_steps.py`, so this chain holds the data-parallel steps to
JAX's one step over the global batch.

One world runs every case once (`_torch_dp_worker.py`, mode `dp`, about
20 s); each test reads a part of what it wrote. The patch step gives the
two ranks different numbers of selected strips (5 and 1) and of two-deep
histories (5 and 0): a mean of per-rank means would differ from the
global mean there. Float32 models, the tolerances of
`test_torch_train_step.py`: losses rel 1e-5, parameters abs 1e-5 on the
entries whose step does not hinge on float32 noise (`param_diffs` in the
worker), batch statistics abs 1e-6. After a step every parameter, Adam
moment, batch statistic and table entry is bitwise the same on both ranks.
"""

import math

import pytest

from _torch_world import case, run_world


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world("dp", 2, tmp_path_factory.mktemp("dp"))


def _close(reading, tol=1e-5, min_held=0.2):
    worst, held, name = reading
    assert worst <= tol, (worst, name)
    assert held > min_held, held


def test_patch_step_counts_differ_per_rank(world):
    r0, _ = case(world, "patch_step")
    assert r0["selected"] == [5, 1]
    assert r0["valid_depth1"] == [5, 0]


def test_patch_step_matches_single_process_on_the_union(world):
    r0, _ = case(world, "patch_step")
    assert r0["loss_b_rel"] <= 1e-5 and r0["loss_a_rel"] <= 1e-5
    assert r0["strips_abs"] <= 1e-6
    _close(r0["unet_params"])
    _close(r0["crnn_params"])
    assert r0["bn_abs"] <= 1e-6
    assert r0["tables_moved"]
    assert r0["cer_abs"] <= 1e-6 and r0["ent_abs"] <= 1e-6


@pytest.mark.parametrize("name", ["patch_step", "warmup_step", "area_steps",
                                  "warmup_trainer", "area_trainer"])
def test_ranks_hold_the_same_bytes(world, name):
    assert all(r["same"] for r in case(world, name))


def test_warmup_step_matches_single_process(world):
    r0, _ = case(world, "warmup_step")
    assert r0["loss_rel"] <= 1e-5
    _close(r0["params"])
    assert r0["bn_moved"] and r0["bn_abs"] <= 1e-6


@pytest.mark.parametrize("step", ["pretrain", "phase_b"])
def test_area_steps_match_single_process(world, step):
    r0, _ = case(world, "area_steps")
    assert r0[step]["loss_rel"] <= 1e-5
    _close(r0[step]["unet_params"])
    assert r0[step]["bn_abs"] <= 1e-6
    assert r0["cer_abs"] <= 1e-6 and r0["ent_abs"] <= 1e-6


def test_warmup_trainer_ledger(world):
    """8 training crops (4 a rank) and 10 validation crops in windows of 8
    (rank 0: 4 + 2, rank 1: 4 + 0), 2 epochs; the logged ledger is the
    sum (`test_crnn_dp.py::test_dp_tail_batch_validation`)."""
    r0, r1 = case(world, "warmup_trainer")
    assert (r0["calls"], r1["calls"]) == (2 * (4 + 6), 2 * (4 + 4))
    assert [r["Total Black-Box Calls"] for r in r0["records"]] == [18, 36]
    for rec in r0["records"]:
        assert math.isfinite(rec["train_loss"])
        assert math.isfinite(rec["val_loss"])
    assert "model_1_0.00" in "".join(r0["checkpoints"])


def test_area_trainer_ledger(world):
    """16 crops in global batches of 8, rangeCER 0.5, 2 OCR rounds: 4 a
    rank a step, 16 in all, as single-process (`test_area_dp.py`); each
    rank also OCRs its 4 validation crops."""
    r0, r1 = case(world, "area_trainer")
    rec = r0["record"]
    assert rec["Black-Box Calls"] == rec["Total Black-Box Calls"] == 16
    assert rec["CRNN Updates"] == 2
    assert r0["calls"] == r1["calls"] == 8 + 4
    for r, res in enumerate((r0, r1)):
        assert f"tracked_labels_current.p{r}.json" in res["side"]


def test_indivisible_batch_raises(world):
    r0, _ = case(world, "indivisible")
    assert len(r0["messages"]) == 2
    for msg in r0["messages"]:
        assert msg and "multiple of the device count" in msg


def test_clean_docs_data_parallel_equals_single_process(world):
    """5 documents, `--batch_size 3` rounded up to 4: the files and their
    bytes, and `clean_arrays_uint8`'s arrays, equal the single-process
    run's."""
    r0, r1 = case(world, "clean_docs")
    assert r0["batch_size"] == r1["batch_size"] == 4
    assert r0["names_dp"] == r0["names_sp"] and len(r0["names_sp"]) == 5
    assert r0["bytes_equal"] and r0["arrays_equal"]
