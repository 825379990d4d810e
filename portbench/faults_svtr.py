"""The SVTR cell's own planted fault, beside `faults.FAULTS`, and the
readings of `control.py` with it:

  window dropped  SVTR's local mask left out (`models/svtr.window_mask`
                  gives none), so every block attends over the whole grid

    python3 -m portbench.faults_svtr --workload area-train-b512-svtr-l \
        --seeds 1 --fault "window dropped" [--out <file.jsonl>]

takes `control.py`'s arguments, and any of `faults.FAULTS` too.
"""

from __future__ import annotations

import contextlib
import sys
from unittest import mock

from portbench import control, faults

FAULTS = ("window dropped",)
PLANTED = faults.planted


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with `fault` planted inside the block."""
    if fault not in FAULTS:
        with PLANTED(fault):
            yield
        return
    from qea_ocr_tpu_torch.models import svtr
    with mock.patch.object(svtr, "window_mask", lambda *a, **kw: None):
        yield


def main(argv=None) -> int:
    with mock.patch.object(faults, "planted", planted):
        return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
