"""The four-card cell's own planted faults, beside `faults.FAULTS`: each
leaves out one exchange between the ranks, which exists only across cards.

  gradients not summed    `sum_gradients` does nothing: every rank applies
                          its own share of the gradient
  local batch statistics  the UNet's train-mode batch norm takes its mean
                          and variance over the rank's own rows (no
                          all-reduce of its sums)

`control_dp4.py --fault` plants one in every rank.
"""

from __future__ import annotations

import contextlib
from unittest import mock

from portbench import faults

FAULTS = ("gradients not summed", "local batch statistics")


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with `fault` planted inside the block."""
    if fault not in FAULTS:
        with faults.planted(fault):
            yield
        return
    from qea_ocr_tpu_torch.models import unet
    from qea_ocr_tpu_torch.train import patch_steps
    with contextlib.ExitStack() as stack:
        if fault == "gradients not summed":
            stack.enter_context(mock.patch.object(
                patch_steps, "sum_gradients", lambda params: None))
        else:
            stack.enter_context(mock.patch.object(
                unet, "global_sum_grad", lambda x: x))
            stack.enter_context(mock.patch.object(
                unet, "global_numel", lambda n: n))
        yield
