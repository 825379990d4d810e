"""CER-seed generation: run the black-box OCR over a training split and emit
the `{strip_name: cer}` JSON consumed by `--cers_ocr_path` (counterpart of
`qea_ocr_tpu/tools/cer_seed.py`).

Counterpart of reference `cer_data_utils/ocr_inference_patch_dataset.py`
(patch variant: keys `{j}_{label}_{folder}_{file}`) and
`cer_data_utils/ocr_inference.py` (textarea variant: word-crop file names).
Strips come out of their documents through the strip gather (`ops/
text_stack.py:get_text_stack`: the gather kernel on a CUDA device, its plain
version on the CPU); CER runs through the native batch edit distance
(`utils/native.py`), OCR through the query engine.

CLI: python -m qea_ocr_tpu_torch.tools.cer_seed --mode patch \
       --data_base_path ... --ocr Fake --out cers.json [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

from qea_ocr_tpu_torch import config as C
from qea_ocr_tpu_torch.ocr.base import get_ocr_helper
from qea_ocr_tpu_torch.ocr.engine import OcrQueryEngine
from qea_ocr_tpu_torch.ops.text_stack import get_text_stack
from qea_ocr_tpu_torch.utils import native
from qea_ocr_tpu_torch.utils.charmap import CharMap
from qea_ocr_tpu_torch.utils.device import resolve_device


def cer_of_batch(ocr_texts, gt_texts, charmap: CharMap) -> np.ndarray:
    p, pl = charmap.encode([charmap.clean(t) for t in ocr_texts])
    g, gl = charmap.encode([charmap.clean(t) for t in gt_texts])
    d = native.batch_levenshtein(p, pl, g, gl)
    return d / np.maximum(gl, 1)


def seed_patch(dataset, engine: OcrQueryEngine, charmap: CharMap,
               device: str | torch.device = "cuda") -> Dict[str, float]:
    """Per-strip initial CERs for a PatchDocuments dataset; the strips are
    cut on `device`, one gather a document."""
    dev = resolve_device(device)
    out: Dict[str, float] = {}
    for sample in dataset.samples:
        rows = np.nonzero(sample.strip_mask)[0]
        strips = get_text_stack(
            torch.from_numpy(sample.image).to(dev),
            torch.from_numpy(sample.bboxes[rows]).to(dev)).cpu().numpy()
        res = engine.query(strips)
        gts = charmap.decode(sample.gt_labels[rows], sample.gt_lengths[rows])
        cers = cer_of_batch(res.texts, gts, charmap)
        for k, r in enumerate(rows):
            out[sample.strip_names[r]] = float(cers[k])
    return out


def seed_area(dataset, engine: OcrQueryEngine,
              charmap: CharMap, batch: int = 64) -> Dict[str, float]:
    """Per-crop initial CERs for a word-crop dataset."""
    out: Dict[str, float] = {}
    n = len(dataset)
    for start in range(0, n, batch):
        samples = [dataset[i] for i in range(start, min(n, start + batch))]
        imgs = np.stack([s.image for s in samples])
        res = engine.query(imgs)
        gts = [s.label for s in samples]
        cers = cer_of_batch(res.texts, gts, charmap)
        for s, c in zip(samples, cers):
            out[s.name] = float(c)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate CER seed JSON")
    p.add_argument("--mode", choices=["patch", "area"], default="patch")
    p.add_argument("--dataset", default="patch",
                   help="patch | pos | vgg | synthetic")
    p.add_argument("--data_base_path", default=".")
    p.add_argument("--ocr", default="Tesseract")
    p.add_argument("--out", required=True)
    p.add_argument("--max_strips", type=int, default=32)
    p.add_argument("--num_subset", type=int)
    p.add_argument("--synthetic_size", type=int, default=32)
    # synthetic-world parameters: they must match the trainer's world
    # exactly, or the seed keys/values won't correspond to its strips
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--strips_per_doc", type=int, default=6)
    p.add_argument("--doc_size", type=int, nargs=2, metavar=("H", "W"))
    p.add_argument("--corruption",
                   help='JSON dict, e.g. \'{"noise_std": 0.18, ...}\'')
    p.add_argument("--device", default="cuda",
                   help="torch device of the strip gather (cuda, cuda:N or "
                        "cpu); a missing GPU is an error")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    charmap = CharMap.default()
    engine = OcrQueryEngine(get_ocr_helper(args.ocr), charmap)
    corruption = json.loads(args.corruption) if args.corruption else None
    if args.mode == "patch":
        from qea_ocr_tpu_torch.data.datasets import PatchDocuments
        if args.dataset == "synthetic":
            ds = PatchDocuments.synthetic(
                args.synthetic_size, seed=args.seed,
                n_strips=args.strips_per_doc, max_strips=args.max_strips,
                corruption=corruption,
                **({"doc_size": tuple(args.doc_size)}
                   if args.doc_size else {}))
        else:
            ds = PatchDocuments(
                os.path.join(args.data_base_path, C.PATCH_TRAIN),
                max_strips=args.max_strips, num_subset=args.num_subset)
        cers = seed_patch(ds, engine, charmap, device=args.device)
    else:
        from qea_ocr_tpu_torch.data.datasets import (
            ImgDataset, SyntheticWordDataset)
        if args.dataset == "synthetic":
            ds = SyntheticWordDataset(args.synthetic_size, seed=args.seed,
                                      corruption=corruption)
        else:
            split = C.POS_TEXT_TRAIN if args.dataset == "pos" \
                else C.VGG_TEXT_TRAIN
            ds = ImgDataset(os.path.join(args.data_base_path, split),
                            num_subset=args.num_subset)
        cers = seed_area(ds, engine, charmap)
    with open(args.out, "w") as f:
        json.dump(cers, f)
    print(f"wrote {len(cers)} CERs to {args.out} "
          f"(bb calls: {engine.total_calls})")


if __name__ == "__main__":
    main()
