"""End-to-end quality run of the area (word-crop) trainer on the synthetic
world: the port's own runner of the pipeline of
`scripts/quality_run_area.py`, with the same environment knobs, defaults and
checks.

  1. CRNN warmup on word crops with fake-OCR labels (`train/crnn_trainer.py`),
     unless `CRNN_CKPT` names a warmed-up proxy to reuse;
  2. budget-aware area training at a fixed OCR query budget, loading the
     proxy (`train/area_trainer.py`): the crops go straight through the
     UNet, and the budget selects per minibatch;
  3. `eval/eval_prep.py` on held-out crops: OCR accuracy/CER on cleaned
     vs original crops.

Success criterion: cleaned-crop OCR accuracy beats original-crop accuracy,
under the query budget. The summary (`summary.json` under `QUALITY_OUT`)
holds the JAX script's keys plus the original crops' accuracy and CER, the
warmup's best CRNN-vs-OCR accuracy, the query ledger and the device.

Run: python -m qea_ocr_tpu_torch.tools.quality_run_area [--device cpu]
(on a CUDA device unless `--device` says otherwise; a missing GPU is an
error).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Optional

from qea_ocr_tpu_torch.tools.quality_run import newest_checkpoint


@dataclasses.dataclass
class Knobs:
    """The environment knobs of `scripts/quality_run_area.py` (the comments
    there say what each does), read and checked by `read_knobs`."""
    corruption: dict
    out: str
    budget_prop: float
    train_size: int
    val_size: int
    eval_size: int
    lr_sched_prep: Optional[str]
    warm_epochs: int
    warmup_ocr: str
    crnn_ckpt: Optional[str]
    area_epochs: int
    prep_pretrain: int
    prep_ema: float
    lr_prep: float
    lr_crnn: float
    scalar: float


def read_knobs(env=None) -> Knobs:
    """Knobs from `env` (default `os.environ`); raises `SystemExit` where the
    JAX script does, before the (long) warmup runs."""
    env = os.environ if env is None else env
    # a corruption at which the black box starts partly able to read the
    # raw crops, so that the proxy has something to mimic
    corruption = json.loads(env.get(
        "CORRUPTION",
        '{"noise_std": 0.14, "shading": 0.18, "salt_pepper": 0.007}'))
    lr_sched_prep = env.get("LR_SCHED_PREP", "") or None
    if lr_sched_prep not in (None, "cosine"):
        raise SystemExit(
            f"LR_SCHED_PREP must be 'cosine' or unset, got {lr_sched_prep!r}")
    return Knobs(
        corruption=corruption,
        out=env.get("QUALITY_OUT",
                    os.path.join(tempfile.gettempdir(), "quality_area")),
        budget_prop=float(env.get("BUDGET_PROP", 0.75)),
        train_size=int(env.get("TRAIN_SIZE", 2048)),
        val_size=int(env.get("VAL_SIZE", 256)),
        eval_size=int(env.get("EVAL_SIZE", 256)),
        lr_sched_prep=lr_sched_prep,
        warm_epochs=int(env.get("WARM_EPOCHS", 30)),
        warmup_ocr=env.get("WARMUP_OCR", "Fake"),
        crnn_ckpt=env.get("CRNN_CKPT") or None,
        area_epochs=int(env.get("AREA_EPOCHS", 30)),
        prep_pretrain=int(env.get("PREP_PRETRAIN", 6)),
        prep_ema=float(env.get("PREP_EMA", 0.0)),
        lr_prep=float(env.get("LR_PREP", 2e-5)),
        lr_crnn=float(env.get("LR_CRNN", 1e-4)),
        scalar=float(env.get("SCALAR", 1.0)))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu); a missing GPU "
                        "is an error")
    device = p.parse_args(argv).device
    k = read_knobs()
    os.makedirs(k.out, exist_ok=True)
    t0 = time.time()
    summary = {}

    crnn_ckpt = k.crnn_ckpt
    if not crnn_ckpt:
        # ------------- 1. CRNN warmup ----------------------------------
        from qea_ocr_tpu_torch.train.crnn_trainer import (
            CrnnTrainerConfig, TrainCRNN)
        # warm the proxy on the black box's outputs, so that it mimics the
        # OCR including its failures on corrupted crops
        warm = TrainCRNN(CrnnTrainerConfig(
            batch_size=64, lr=3e-4, epochs=k.warm_epochs,
            dataset="synthetic", synthetic_train_size=4096,
            synthetic_val_size=256, corruption=k.corruption,
            ocr=k.warmup_ocr, std=3,
            crnn_model_path=os.path.join(k.out, "crnn/model"),
            log_dir=os.path.join(k.out, "crnn"), device=device))
        best_acc, best_epoch = warm.train()
        summary["warmup_best_acc"] = best_acc
        summary["warmup_best_epoch"] = best_epoch
        summary["warmup_seconds"] = round(time.time() - t0, 1)
        print(f"[warmup] best acc {best_acc:.3f} @ {best_epoch} "
              f"({time.time() - t0:.0f}s)", flush=True)
        crnn_ckpt = newest_checkpoint(os.path.join(k.out, "crnn/model_*"))

    # ---------------- 2. budget-aware area training ---------------------
    from qea_ocr_tpu_torch.train.area_trainer import (
        AreaTrainerConfig, TrainNNPrepArea)
    trainer = TrainNNPrepArea(AreaTrainerConfig(
        epochs=k.area_epochs, ocr="Fake", dataset="synthetic",
        synthetic_train_size=k.train_size, synthetic_val_size=k.val_size,
        batch_size=64, corruption=k.corruption,
        minibatch_subset="rangeCER", minibatch_subset_prop=k.budget_prop,
        inner_limit=2, inner_limit_skip=True, window_size=3,
        weightgen_method="decaying", scalar=k.scalar,
        prep_pretrain_epochs=k.prep_pretrain, prep_ema=k.prep_ema,
        lr_prep=k.lr_prep, lr_scheduler_prep=k.lr_sched_prep,
        lr_crnn=k.lr_crnn, crnn_model=crnn_ckpt,
        exp_base_path=os.path.join(k.out, "area"), device=device))
    best_acc, best_epoch = trainer.train()
    with open(os.path.join(k.out, "area", "metrics.jsonl")) as f:
        last = [json.loads(line) for line in f][-1]
    print(f"[area] best OCR acc on cleaned crops {best_acc:.3f} @ epoch "
          f"{best_epoch}; total bb calls {trainer.ocr.total_calls} "
          f"({time.time() - t0:.0f}s)", flush=True)

    # ---------------- 3. held-out eval: cleaned vs original -------------
    from qea_ocr_tpu_torch.eval.eval_prep import EvalPrep, EvalPrepConfig
    ckpts = os.path.join(k.out, "area/ckpts")
    prep_path = newest_checkpoint(os.path.join(ckpts, "Prep_model_best")) \
        or newest_checkpoint(os.path.join(ckpts, "Prep_model_*"))
    ev = EvalPrep(EvalPrepConfig(
        prep_path=prep_path, dataset="synthetic_area", ocr="Fake",
        synthetic_size=k.eval_size, batch_size=64, corruption=k.corruption,
        random_seed=1234, show_orig=True, device=device))
    acc, cer = ev.eval()
    summary = dict(cleaned_acc=acc, cleaned_cer=cer,
                   best_train_val_acc=best_acc,
                   budget=round(1.0 - k.budget_prop, 4),
                   total_seconds=round(time.time() - t0, 1),
                   original_acc=ev.original[0], original_cer=ev.original[1],
                   best_epoch=best_epoch,
                   train_bb_calls=last["Total Black-Box Calls"],
                   total_bb_calls=trainer.ocr.total_calls,
                   **summary, device=str(ev.device))
    with open(os.path.join(k.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("[summary]", json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
