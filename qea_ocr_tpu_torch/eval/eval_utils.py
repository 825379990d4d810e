"""Programmatic evaluation API (counterpart of
`qea_ocr_tpu/eval/eval_utils.py`).

Counterpart of reference `eval_utils.py:4-22` (`prep_eval`): a plain-dict
entry point returning `{"test_accuracy", "test_cer"}` for sweeps and
notebooks. The dict may name a `device` (default `cuda`).
"""

from __future__ import annotations

from typing import Any, Dict

from qea_ocr_tpu_torch.eval.eval_prep import EvalPrep, EvalPrepConfig


def prep_eval(eval_args: Dict[str, Any]) -> Dict[str, float]:
    cfg = EvalPrepConfig(**eval_args)
    evaluator = EvalPrep(cfg)
    accuracy, cer = evaluator.eval()
    return {"test_accuracy": accuracy, "test_cer": cer}
