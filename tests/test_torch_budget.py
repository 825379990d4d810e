"""The budget-aware trainers' shared core
(`qea_ocr_tpu_torch/train/budget.py`), held on both trainers, the patch
trainer's document strips and the area trainer's word crops, on the tiny
synthetic worlds of `tests/test_torch_patch_trainer.py` and
`tests/test_torch_area_trainer.py`: the optuna report and prune, and a
step whose batch has no selected row."""

import numpy as np
import pytest

import test_torch_area_trainer as area
import test_torch_patch_trainer as patch
from qea_ocr_tpu_torch.train.area_trainer import TrainNNPrepArea
from qea_ocr_tpu_torch.train.patch_trainer import TrainNNPrep

from _torch_parity import RecordingTrial, trial_pruned_type

# (trainer, its test module, validation queries an epoch)
TRAINERS = {"patch": (TrainNNPrep, patch, patch.VAL_CALLS),
            "area": (TrainNNPrepArea, area, area.VAL)}


def make(kind, tmp, **overrides):
    cls, mod, _ = TRAINERS[kind]
    return cls(mod.tiny_cfg(tmp, **overrides))


@pytest.mark.parametrize("kind", sorted(TRAINERS))
def test_optuna_trial_reports_and_prunes(kind, tmp_path):
    """Each epoch's validation accuracy (in %) goes to the trial; a trial
    that asks to prune after epoch 0 ends the run there."""
    trial = RecordingTrial(prune_after=0)
    trainer = make(kind, tmp_path, optuna_trial=trial)
    with pytest.raises(trial_pruned_type()):
        trainer.train()
    recs = TRAINERS[kind][1]._records(tmp_path)
    assert len(recs) == 1
    assert trial.reports == [(recs[0]["Fake_accuracy"] * 100, 0)]


@pytest.mark.parametrize("kind", sorted(TRAINERS))
def test_zero_selection_batch_with_samplewise_weights(kind, tmp_path):
    """prop 0.95 -> one row is selected globally (one strip of 12, one crop
    of 16), so one of the epoch's two batches has no selected row: the step
    still runs, its tracking loss fully masked."""
    trainer = make(kind, tmp_path, epochs=1, minibatch_subset="randomglobal",
                   minibatch_subset_prop=0.95, weightgen_method="levenshtein")
    trainer.train()
    assert trainer.global_bitmap.sum() == 1
    # the selected row, once clean and once jittered
    assert trainer.ocr.total_calls == 2 + TRAINERS[kind][2]
    rec = TRAINERS[kind][1]._records(tmp_path)[0]
    assert rec["CRNN Updates"] == 2 and np.isfinite(rec["CRNN_loss"])
