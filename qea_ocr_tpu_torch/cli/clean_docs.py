"""Serving CLI: clean a directory of document images with a trained UNet,
optionally transcribing the cleaned output (counterpart of
`qea_ocr_tpu/cli/clean_docs.py`).

Run: python -m qea_ocr_tpu_torch.cli.clean_docs --prep_path prep.pt \
       --input_dir docs/ --output_dir cleaned/ [--ocr Tesseract \
       --transcripts transcripts.json] [--device cuda]

`--prep_path` is a reference-schema state_dict file, e.g. one written by
`python -m qea_ocr_tpu.tools.export_torch --kind prep`.
"""

from __future__ import annotations

import argparse
import json
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Batch document cleaning with a trained preprocessor")
    p.add_argument("--prep_path", required=True,
                   help="reference-schema UNet state_dict file")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--ocr", default=None,
                   help="optional OCR backend to transcribe cleaned docs")
    p.add_argument("--transcripts", default=None,
                   help="JSON output path for transcriptions (with --ocr)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--unet_features", type=int, default=32)
    p.add_argument("--doc_size", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="processing canvas (default: config DOC_SIZE)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu); a missing GPU "
                        "is an error, not a fallback")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from qea_ocr_tpu.ocr.base import get_ocr_helper
    from qea_ocr_tpu_torch.serve.cleaner import DocumentCleaner

    ocr = get_ocr_helper(args.ocr, is_eval=True) if args.ocr else None
    if args.ocr and ocr is None:
        raise ValueError(f"unknown OCR backend {args.ocr!r}")
    kw = {"doc_size": tuple(args.doc_size)} if args.doc_size else {}
    cleaner = DocumentCleaner(
        args.prep_path, device=args.device, batch_size=args.batch_size,
        unet_features=args.unet_features, **kw)
    t0 = time.perf_counter()
    result = cleaner.clean_dir(
        args.input_dir, args.output_dir, ocr=ocr,
        transcripts_path=args.transcripts)
    result["seconds"] = round(time.perf_counter() - t0, 2)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
