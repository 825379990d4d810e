"""The port's trainer times the same stages as the JAX trainer, so that its
`metrics.jsonl` holds every `time/<stage>_*` key that a JAX run writes.

The stage names are read from the source of both trainers (the literal
argument of each `timer.time(...)`); no trainer runs here. The keys of a
run of the port are held in `tests/test_torch_patch_trainer.py`.
"""

import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[1]
STAGE = re.compile(r"""timer\.time\(\s*["']([A-Za-z0-9_]+)["']\s*\)""")
# the stages of the JAX trainer's epoch loop
JAX_STAGES = {"prep_extract", "ocr_issue", "ocr_wait", "phase_ab", "phase_b"}


def _stages(path: str) -> set:
    return set(STAGE.findall((ROOT / path).read_text()))


def test_port_trainer_times_every_stage_of_the_jax_trainer():
    jax_stages = _stages("qea_ocr_tpu/train/patch_trainer.py")
    port_stages = _stages("qea_ocr_tpu_torch/train/patch_trainer.py")
    assert jax_stages >= JAX_STAGES, jax_stages
    assert port_stages >= jax_stages, sorted(jax_stages - port_stages)
