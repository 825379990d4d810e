"""Dataset-pruning CLI.

Counterpart of reference `pruning/prune_dataset.py` __main__: build a
topk / facility-location pruning artifact from a strip-level CER JSON.

CLI: python -m qea_ocr_tpu_torch.tools.prune_cli --cers cers.json \
       --method topk --num_samples 100 --out_dir pruning/cer_artifacts \
       --artifact_name cers_pos_topk_100

The port's own copy of `qea_ocr_tpu/tools/prune_cli.py` (numpy only): the
port imports nothing of the JAX package, and `tests/test_torch_tooling.py`
holds the copy equal to its original.
"""

from __future__ import annotations

import argparse
import json

from qea_ocr_tpu_torch.pruning.prune import DatasetPruner


def main(argv=None):
    p = argparse.ArgumentParser(description="Prune a document dataset by CER")
    p.add_argument("--cers", required=True, help="strip-level CER json")
    p.add_argument("--method", choices=["topk", "FL"], default="topk")
    p.add_argument("--num_samples", type=int, required=True)
    p.add_argument("--out_dir", default="pruning/cer_artifacts")
    p.add_argument("--artifact_name", required=True)
    args = p.parse_args(argv)

    with open(args.cers) as f:
        strip_cers = json.load(f)
    pruner = DatasetPruner(strip_cers, args.method, args.num_samples)
    path = pruner.save(args.out_dir, args.artifact_name)
    print(f"wrote pruning artifact: {path} "
          f"({min(args.num_samples, len(pruner.cer_means))} docs)")


if __name__ == "__main__":
    main()
