"""End-to-end quality run on the synthetic world: the port's own runner of
the pipeline of `scripts/quality_run.py`, with the same environment knobs,
defaults and checks.

  1. CRNN warmup on word crops with fake-OCR labels (`train/crnn_trainer.py`);
  1b. optionally, CER priors of every training strip (`tools/cer_seed.py`);
  2. budget-aware patch training at a fixed OCR query budget, loading the
     warmed-up proxy (`train/patch_trainer.py`);
  3. `eval/eval_prep.py` on held-out documents: OCR accuracy/CER on cleaned
     vs original strips.

Success criterion: cleaned-strip OCR accuracy beats original-strip accuracy
at the end, under the query budget. The summary (`summary.json` under
`QUALITY_OUT`) holds the JAX script's keys plus the original strips'
accuracy and CER, the warmup's best CRNN-vs-OCR accuracy, the training query
ledger and the device.

Run: python -m qea_ocr_tpu_torch.tools.quality_run [--device cpu]
(on a CUDA device unless `--device` says otherwise; a missing GPU is an
error).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import tempfile
import time
from typing import Optional

from qea_ocr_tpu_torch.config import SELECTION_KEYS, WEIGHTGEN_KEYS

CORRUPTION = dict(noise_std=0.18, shading=0.25, salt_pepper=0.01)


@dataclasses.dataclass
class Knobs:
    """The environment knobs of `scripts/quality_run.py` (the comments
    there say what each does), read and checked by `read_knobs`."""
    warmup_corruption: dict
    out: str
    budget_prop: float
    strips_per_doc: int
    doc_size: tuple
    selection: str
    weightgen: str
    train_docs: int
    val_docs: int
    eval_docs: int
    warm_size: int
    batch_docs: int
    lr_prep: float
    lr_crnn: float
    step_match: bool
    micro_steps: int


def read_knobs(env=None) -> Knobs:
    """Knobs from `env` (default `os.environ`); raises `SystemExit` on the
    combinations the JAX script refuses."""
    env = os.environ if env is None else env
    # the warmup trains on isolated word crops, where corruption at the
    # document-level parameters is much harsher than on the strips cut from
    # corrupted documents: warm up at a crop-level corruption calibrated to
    # the strip distribution
    warmup_corruption = json.loads(env.get(
        "WARMUP_CORRUPTION",
        '{"noise_std": 0.14, "shading": 0.18, "salt_pepper": 0.007}'))
    lr_scale = float(env.get("LR_SCALE", 1.0))
    batch_docs = int(env.get("BATCH_DOCS", 8))
    micro_steps = int(env.get("MICRO_STEPS", 1))
    step_match = env.get("STEP_MATCH", "1") not in ("0", "false")
    if micro_steps > 1:
        # the optimizer steps come from the chunks, not from extra epochs
        step_match = False
        if batch_docs % micro_steps:
            raise SystemExit(f"MICRO_STEPS={micro_steps} must divide "
                             f"BATCH_DOCS={batch_docs}")
    k = Knobs(
        warmup_corruption=warmup_corruption,
        out=env.get("QUALITY_OUT",
                    os.path.join(tempfile.gettempdir(), "quality_run")),
        budget_prop=float(env.get("BUDGET_PROP", 0.75)),
        strips_per_doc=int(env.get("STRIPS_PER_DOC", 8)),
        doc_size=tuple(int(v) for v in
                       env.get("DOC_SIZE", "400,512").split(",")),
        selection=env.get("SELECTION", "rangeCER"),
        weightgen=env.get("WEIGHTGEN", "decaying"),
        train_docs=int(env.get("TRAIN_DOCS", 256)),
        val_docs=int(env.get("VAL_DOCS", 16)),
        eval_docs=int(env.get("EVAL_DOCS", 16)),
        warm_size=int(env.get("WARM_SIZE", 4096)),
        batch_docs=batch_docs,
        lr_prep=float(env.get("LR_PREP", 5e-5)) * lr_scale,
        lr_crnn=float(env.get("LR_CRNN", 1e-4)) * lr_scale,
        step_match=step_match, micro_steps=micro_steps)
    if k.selection not in SELECTION_KEYS:
        raise SystemExit(f"unknown SELECTION {k.selection!r} "
                         f"(one of {SELECTION_KEYS})")
    if k.weightgen not in WEIGHTGEN_KEYS:
        raise SystemExit(f"unknown WEIGHTGEN {k.weightgen!r} "
                         f"(one of {WEIGHTGEN_KEYS})")
    if k.doc_size[0] // k.strips_per_doc < 18:
        raise SystemExit(
            f"DOC_SIZE height {k.doc_size[0]} fits only "
            f"{k.doc_size[0] // 18} non-overlapping 18px strip rows; "
            f"STRIPS_PER_DOC={k.strips_per_doc} would overwrite earlier "
            f"strips while the sidecar labels keep pointing at them. Raise "
            f"DOC_SIZE (e.g. DOC_SIZE=512,512 for 25 strips).")
    return k


def newest_checkpoint(pattern: str) -> Optional[str]:
    """The newest model file matching `pattern`, by modification time. A
    checkpoint is two files; the optimizer's (`.optim`) is never picked."""
    from qea_ocr_tpu_torch.utils.io import OPTIM_SUFFIX

    paths = [p for p in glob.glob(pattern) if not p.endswith(OPTIM_SUFFIX)]
    return max(paths, key=os.path.getmtime) if paths else None


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu); a missing GPU "
                        "is an error")
    device = p.parse_args(argv).device
    env = os.environ
    k = read_knobs(env)
    os.makedirs(k.out, exist_ok=True)
    t0 = time.time()
    summary = {}

    crnn_ckpt = env.get("CRNN_CKPT")  # reuse a previous warmup
    if not crnn_ckpt:
        # ------------- 1. CRNN warmup ----------------------------------
        from qea_ocr_tpu_torch.train.crnn_trainer import (
            CrnnTrainerConfig, TrainCRNN)
        # warm the proxy on the black box's outputs by default, so that it
        # mimics the OCR including its failures; WARMUP_OCR=gt warms it on
        # the ground truth
        warm_ocr = env.get("WARMUP_OCR", "Fake")
        warm = TrainCRNN(CrnnTrainerConfig(
            batch_size=64, lr=3e-4, epochs=int(env.get("WARM_EPOCHS", 30)),
            dataset="synthetic", synthetic_train_size=k.warm_size,
            synthetic_val_size=256, corruption=k.warmup_corruption,
            ocr=None if warm_ocr == "gt" else warm_ocr, std=3,
            crnn_model_path=os.path.join(k.out, "crnn/model"),
            log_dir=os.path.join(k.out, "crnn"), device=device))
        best_acc, best_epoch = warm.train()
        summary["warmup_best_acc"] = best_acc
        summary["warmup_best_epoch"] = best_epoch
        summary["warmup_seconds"] = round(time.time() - t0, 1)
        print(f"[warmup] best CRNN-vs-OCR acc {best_acc:.3f} @ {best_epoch} "
              f"({time.time() - t0:.0f}s)", flush=True)
        crnn_ckpt = newest_checkpoint(os.path.join(k.out, "crnn/model_*"))

    # ---------------- 1b. optional seed-CER priors -----------------------
    # CERS_SEED=1: OCR every raw training strip once offline and hand the
    # {strip_name: cer} table to the trainer; its queries are an offline
    # ledger, reported apart from the training budget
    cers_path = env.get("CERS_OCR_PATH")
    if not cers_path and env.get("CERS_SEED") == "1":
        from qea_ocr_tpu_torch.data.datasets import PatchDocuments
        from qea_ocr_tpu_torch.ocr.base import get_ocr_helper
        from qea_ocr_tpu_torch.ocr.engine import OcrQueryEngine
        from qea_ocr_tpu_torch.tools.cer_seed import seed_patch
        from qea_ocr_tpu_torch.utils.charmap import CharMap
        ds = PatchDocuments.synthetic(
            k.train_docs, seed=42, n_strips=k.strips_per_doc,
            max_strips=k.strips_per_doc, corruption=CORRUPTION,
            doc_size=k.doc_size)
        cm = CharMap.default()
        eng = OcrQueryEngine(get_ocr_helper("Fake"), cm)
        cers = seed_patch(ds, eng, cm, device=device)
        cers_path = os.path.join(k.out, "cers_seed.json")
        with open(cers_path, "w") as f:
            json.dump(cers, f)
        summary["seed_bb_calls"] = eng.total_calls
        print(f"[seed] wrote {len(cers)} strip CER priors to {cers_path} "
              f"({eng.total_calls} offline bb calls, not in the training "
              f"ledger) ({time.time() - t0:.0f}s)", flush=True)

    # ---------------- 2. budget-aware patch training --------------------
    from qea_ocr_tpu_torch.train.patch_trainer import (
        PatchTrainerConfig, TrainNNPrep)
    patch_epochs = int(env.get("PATCH_EPOCHS", 20))
    if k.step_match and k.batch_docs > 2:
        patch_epochs = patch_epochs * k.batch_docs // 2
        print(f"[recipe] STEP_MATCH: PATCH_EPOCHS scaled to {patch_epochs} "
              f"(x{k.batch_docs // 2}) to hold optimizer steps at the "
              f"BATCH_DOCS=2 reference count; per-epoch query ledger "
              f"unchanged", flush=True)
    trainer = TrainNNPrep(PatchTrainerConfig(
        epochs=patch_epochs, ocr="Fake", dataset="synthetic",
        synthetic_train_docs=k.train_docs, synthetic_val_docs=k.val_docs,
        synthetic_strips_per_doc=k.strips_per_doc,
        max_strips=k.strips_per_doc, batch_docs=k.batch_docs,
        micro_steps=k.micro_steps,
        micro_refresh=env.get("MICRO_REFRESH", "0") not in ("0", "", "false"),
        doc_size=k.doc_size, corruption=CORRUPTION,
        minibatch_subset=k.selection, minibatch_subset_prop=k.budget_prop,
        inner_limit=2, inner_limit_skip=True, window_size=3,
        weightgen_method=k.weightgen, scalar=0.1,
        prep_pretrain_epochs=int(env.get("PREP_PRETRAIN", 8)),
        prep_ema=float(env.get("PREP_EMA", 0.0)),
        lr_prep=k.lr_prep, lr_crnn=k.lr_crnn, crnn_model=crnn_ckpt,
        cers_ocr_path=cers_path,
        exp_base_path=os.path.join(k.out, "patch"), device=device))
    best_acc, best_epoch = trainer.train()
    with open(os.path.join(k.out, "patch", "metrics.jsonl")) as f:
        last = [json.loads(line) for line in f][-1]
    print(f"[patch] best OCR acc on cleaned strips {best_acc:.3f} @ epoch "
          f"{best_epoch}; total bb calls {trainer.ocr.total_calls} "
          f"({time.time() - t0:.0f}s)", flush=True)

    # ---------------- 3. held-out eval: cleaned vs original -------------
    from qea_ocr_tpu_torch.eval.eval_prep import EvalPrep, EvalPrepConfig
    ckpts = os.path.join(k.out, "patch/ckpts")
    prep_path = newest_checkpoint(os.path.join(ckpts, "Prep_model_best")) \
        or newest_checkpoint(os.path.join(ckpts, "Prep_model_*"))
    ev = EvalPrep(EvalPrepConfig(
        prep_path=prep_path, dataset="synthetic_patch", ocr="Fake",
        synthetic_docs=k.eval_docs, max_strips=k.strips_per_doc,
        synthetic_strips_per_doc=k.strips_per_doc, batch_docs=8,
        doc_size=k.doc_size, corruption=CORRUPTION, random_seed=1234,
        show_orig=True, device=device))
    acc, cer = ev.eval()
    summary = dict(cleaned_acc=acc, cleaned_cer=cer,
                   best_train_val_acc=best_acc,
                   budget=round(1.0 - k.budget_prop, 4),
                   total_seconds=round(time.time() - t0, 1),
                   original_acc=ev.original[0], original_cer=ev.original[1],
                   train_bb_calls=last["Total Black-Box Calls"],
                   train_val_bb_calls=last["Total Train + Val BB Calls"],
                   **summary, device=str(ev.device))
    with open(os.path.join(k.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("[summary]", json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
