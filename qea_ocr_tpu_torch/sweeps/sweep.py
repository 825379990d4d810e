"""Hyperparameter sweeps (optuna-gated).

Counterpart of reference `hyperparam_sweeps/patch_sweep.py:56-96` (tunes
lr_crnn/lr_prep with a ThresholdPruner val-accuracy floor; RDB sqlite
storage so SLURM-style job arrays can run one trial per process) and
`hyperparam_sweeps/crnn_sweep.py` (lr/std).

Optuna is not baked into every image; when missing, a self-contained
random-search fallback keeps the surface usable.

CLI: python -m qea_ocr_tpu_torch.sweeps.sweep --which patch --n_trials 3 \
       --storage sqlite:///sweep.db --ocr Fake --dataset synthetic \
       [--device cuda]

`--device` (default `cuda`; `cpu` on request) goes into every trial's
trainer config; a missing GPU is an error, not a fallback.

The port's own copy of `qea_ocr_tpu/sweeps/sweep.py`: the port imports
nothing of the JAX package, and `tests/test_torch_tooling.py` holds the copy
equal to its original.
"""

from __future__ import annotations

import argparse

import json
from typing import Optional

try:
    import optuna
    # a minimal stand-in (e.g. the reference-oracle shim, tools/ref_shims
    # — TrialPruned only) is NOT a usable optuna: fall back to the
    # optuna-free random-search path it cannot serve
    HAVE_OPTUNA = hasattr(optuna, "pruners") and hasattr(optuna, "create_study")
except ImportError:  # pragma: no cover
    HAVE_OPTUNA = False


def patch_objective(trial, base_kwargs: dict) -> float:
    from qea_ocr_tpu_torch.train.patch_trainer import (
        PatchTrainerConfig, TrainNNPrep)
    lr_crnn = trial.suggest_float("lr_crnn", 5e-6, 5e-4, log=True)
    lr_prep = trial.suggest_float("lr_prep", 5e-6, 5e-4, log=True)
    cfg = PatchTrainerConfig(lr_crnn=lr_crnn, lr_prep=lr_prep,
                             optuna_trial=trial, **base_kwargs)
    best_acc, _ = TrainNNPrep(cfg).train()
    return best_acc * 100


def crnn_objective(trial, base_kwargs: dict) -> float:
    from qea_ocr_tpu_torch.train.crnn_trainer import CrnnTrainerConfig, TrainCRNN
    lr = trial.suggest_float("lr", 1e-5, 1e-3, log=True)
    std = trial.suggest_int("std", 1, 10)
    cfg = CrnnTrainerConfig(lr=lr, std=std, **base_kwargs)
    best_acc, _ = TrainCRNN(cfg).train()
    return best_acc * 100


class _RandomTrial:
    """Minimal optuna-free trial: random suggestions, no pruning."""

    def __init__(self, rng):
        self.rng = rng
        self.params = {}

    def suggest_float(self, name, lo, hi, log=False):
        import numpy as np
        v = (float(np.exp(self.rng.uniform(np.log(lo), np.log(hi))))
             if log else float(self.rng.uniform(lo, hi)))
        self.params[name] = v
        return v

    def suggest_int(self, name, lo, hi):
        v = int(self.rng.integers(lo, hi + 1))
        self.params[name] = v
        return v

    def report(self, *a):
        pass

    def should_prune(self):
        return False


def run_sweep(which: str, n_trials: int, storage: Optional[str],
              study_name: str, acc_floor: float, warmup_epochs: int,
              base_kwargs: dict) -> dict:
    objective = patch_objective if which == "patch" else crnn_objective
    if HAVE_OPTUNA:
        pruner = optuna.pruners.ThresholdPruner(
            lower=acc_floor, n_warmup_steps=warmup_epochs)
        study = optuna.create_study(
            study_name=study_name, storage=storage, direction="maximize",
            pruner=pruner, load_if_exists=True)
        study.optimize(lambda t: objective(t, base_kwargs),
                       n_trials=n_trials,
                       catch=(RuntimeError,))
        return dict(best_value=study.best_value, best_params=study.best_params)
    # fallback: random search
    import numpy as np
    rng = np.random.default_rng(0)
    best_value, best_params = -1.0, {}
    for _ in range(n_trials):
        trial = _RandomTrial(rng)
        value = objective(trial, base_kwargs)
        if value > best_value:
            best_value, best_params = value, dict(trial.params)
    return dict(best_value=best_value, best_params=best_params)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Hyperparameter sweep")
    p.add_argument("--which", choices=["patch", "crnn"], default="patch")
    p.add_argument("--n_trials", type=int, default=1)
    p.add_argument("--storage", help="optuna RDB url (sqlite:///sweep.db)")
    p.add_argument("--study_name", default="qea_sweep")
    p.add_argument("--acc_floor", type=float, default=35.0,
                   help="ThresholdPruner lower bound (val acc %)")
    p.add_argument("--pruner_warmup", type=int, default=2)
    p.add_argument("--epoch", type=int, default=3)
    p.add_argument("--ocr", default="Fake")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--exp_base_path", default="./sweep_out")
    p.add_argument("--out", help="write result json here")
    p.add_argument("--device", default="cuda",
                   help="torch device of every trial (cuda, cuda:N or cpu)")
    p.add_argument("--world_json",
                   help="JSON dict of extra trainer-config overrides merged "
                        "into every trial (e.g. shrink the synthetic world "
                        "for smoke sweeps / SLURM array probes)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.which == "patch":
        base = dict(epochs=args.epoch, ocr=args.ocr, dataset=args.dataset,
                    exp_base_path=args.exp_base_path, device=args.device)
    else:
        base = dict(epochs=args.epoch, ocr=args.ocr, dataset=args.dataset,
                    crnn_model_path=args.exp_base_path + "/model",
                    device=args.device)
    if args.world_json:
        base.update(json.loads(args.world_json))
    result = run_sweep(args.which, args.n_trials, args.storage,
                       args.study_name, args.acc_floor, args.pruner_warmup,
                       base)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    main()
