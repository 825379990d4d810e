"""The readings that the limits of `correct` are set from, on the card at
the cell's own size, many seeds in one process:

    python3 -m portbench.control --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out <file.jsonl>]

For each seed: the program's set-up (the steps the reference follows; for
serving, `sample_requests` requests at the cell's load), then the numbers
compared for the program and, on the control seeds, for the control: the
reference in the program's place at the precision below the one the
configuration states (`reference/precision.py`). One JSON line a seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench import faults, harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    p.add_argument("--fault", default=None,
                   help="plant one of portbench.faults.FAULTS in the program")
    p.add_argument("--detail", default=None,
                   help="also write each step's loss gaps and each leaf's "
                        "norms (JSON lines) to this file")
    args = p.parse_args(argv)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.Cell(bench, args.workload)
    harness.set_environment({**cell.config.get("env", {}),
                             **cell.traffic.get("env", {})})
    import torch
    from portbench.reference import precision
    if not torch.cuda.is_available():
        print("[control] needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, dev)
        driver = cell.driver_class()(run)
        with faults.planted(args.fault):
            driver.setup()
            if cell.traffic["driver"] == "serve":
                for i in range(int(cell.traffic["sample_requests"])):
                    driver.step(i)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        driver.release()
        torch.cuda.empty_cache()
        q = precision.control(cell.config) if seed in control_seeds \
            else None
        t1 = time.perf_counter()
        prog, ctl = driver.readings(q)
        line = {"workload": cell.name, "seed": seed, "fault": args.fault,
                "setup_s": setup,
                "reference_s": time.perf_counter() - t1,
                "memory_peak_bytes": peak, "program": dict(prog),
                "control": None if ctl is None else dict(ctl)}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        if args.detail and getattr(driver, "detail", None):
            with open(args.detail, "a") as f:
                f.write(json.dumps({"seed": seed, **driver.detail}) + "\n")
        del driver, run
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
