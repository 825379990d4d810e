"""CER analysis + easy/hard dataset splitting.

Counterpart of reference `cer_data_utils/cer_analysis_datasplit.py:52-179`
and `cer_data_utils/patch_image_mapping.py:19-64`: group strip CERs per
document, summarize the distribution, and physically split a document
dataset tree into easy/hard subsets by mean-CER threshold.

CLI: python -m qea_ocr_tpu_torch.tools.cer_analysis --cers cers.json \
       --threshold 0.3 [--src_dir data --out_dir split]

The port's own copy of `qea_ocr_tpu/tools/cer_analysis.py` (numpy only): the
port imports nothing of the JAX package, and `tests/test_torch_tooling.py`
holds the copy equal to its original.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict, Tuple

import numpy as np

from qea_ocr_tpu_torch.pruning.prune import doc_mean_cers


def cer_summary(doc_cers: Dict[str, float], bins: int = 10) -> dict:
    vals = np.asarray(list(doc_cers.values()), np.float64)
    hist, edges = np.histogram(vals, bins=bins)
    return dict(
        count=int(vals.size),
        mean=float(vals.mean()) if vals.size else 0.0,
        median=float(np.median(vals)) if vals.size else 0.0,
        p90=float(np.percentile(vals, 90)) if vals.size else 0.0,
        histogram=hist.tolist(),
        bin_edges=[float(e) for e in edges],
    )


def split_by_threshold(doc_cers: Dict[str, float],
                       threshold: float) -> Tuple[list, list]:
    """-> (easy doc keys (cer <= t), hard doc keys (cer > t))."""
    easy = [k for k, v in doc_cers.items() if v <= threshold]
    hard = [k for k, v in doc_cers.items() if v > threshold]
    return easy, hard


def copy_split(src_dir: str, out_dir: str, easy: list, hard: list) -> dict:
    """Copy document images (+ bbox sidecars) into easy/ and hard/ trees.
    Document keys are '{folder}_{file}' (reference key format)."""
    copied = dict(easy=0, hard=0)
    index = {}
    for root, _, files in os.walk(src_dir):
        for f in files:
            if f.lower().endswith((".png", ".jpg", ".jpeg")):
                folder = os.path.basename(root)
                key = f"{folder}_{os.path.splitext(f)[0]}"
                index[key] = os.path.join(root, f)
    for name, keys in (("easy", easy), ("hard", hard)):
        dst_root = os.path.join(out_dir, name)
        os.makedirs(dst_root, exist_ok=True)
        for key in keys:
            src = index.get(key)
            if not src:
                continue
            shutil.copy2(src, dst_root)
            sidecar = os.path.splitext(src)[0] + ".json"
            if os.path.exists(sidecar):
                shutil.copy2(sidecar, dst_root)
            copied[name] += 1
    return copied


def main(argv=None):
    p = argparse.ArgumentParser(description="CER analysis / dataset split")
    p.add_argument("--cers", required=True, help="strip-level CER json")
    p.add_argument("--threshold", type=float, default=0.3)
    p.add_argument("--src_dir", help="document tree to split")
    p.add_argument("--out_dir", help="output root for easy/ hard/")
    p.add_argument("--summary_out", help="write summary JSON here")
    args = p.parse_args(argv)

    with open(args.cers) as f:
        strip_cers = json.load(f)
    doc_cers = doc_mean_cers(strip_cers)
    summary = cer_summary(doc_cers)
    easy, hard = split_by_threshold(doc_cers, args.threshold)
    summary["easy_docs"] = len(easy)
    summary["hard_docs"] = len(hard)
    print(json.dumps(summary, indent=2))
    if args.summary_out:
        with open(args.summary_out, "w") as f:
            json.dump(summary, f)
    if args.src_dir and args.out_dir:
        copied = copy_split(args.src_dir, args.out_dir, easy, hard)
        print(f"copied: {copied}")


if __name__ == "__main__":
    main()
