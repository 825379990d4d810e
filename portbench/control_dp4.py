"""`control.py` for the four-card cell (`drivers/train_patch_dp4.py`): the
readings its limits are set from, one seed an invocation (each starts its
own group of ranks), every rank planting the same fault and following the
same control:

    python3 -m portbench.control_dp4 --workload patch-train-d96-dp4 \
        --seeds 1 [--control-seeds 1] [--fault "state unchanged"] \
        [--out <file.jsonl>]

takes `control.py`'s arguments; `--fault` names one of `faults.FAULTS` or
of `faults_dp4.FAULTS` (an exchange between the ranks left out).
"""

from __future__ import annotations

import argparse
import os
import sys
from unittest import mock

from portbench import control, faults, faults_dp4
from portbench.drivers import train_patch_dp4 as dp


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default=None)
    args, _ = p.parse_known_args(argv)
    if len(args.seeds.split(",")) != 1:
        raise SystemExit("one seed an invocation: each starts its own group")
    os.environ[dp.FAULT_VAR] = args.fault or ""
    os.environ[dp.CONTROL_VAR] = "1" if args.seeds in \
        args.control_seeds.split(",") else ""
    with mock.patch.object(faults, "planted", faults_dp4.planted):
        return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
