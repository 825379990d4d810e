"""Run one cell of the benchmark of `qea_ocr_tpu_torch` on this machine's
CUDA cards:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output (see
`portbench/harness.py`). Exits non-zero, with no result, without the cards
the cell asks for.
"""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys

    from portbench import harness
    sys.exit(harness.main(t_start=T_START))
