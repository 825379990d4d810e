"""Prep-evaluation CLI (counterpart of `qea_ocr_tpu/cli/eval_prep.py`): flag
for flag the JAX package's, which is the reference's `eval_prep.py:185-201`,
plus `--device`.

Run: python -m qea_ocr_tpu_torch.cli.eval_prep --prep_path <ckpt> --ocr Fake \
       --dataset synthetic_patch

`QEA_CONV_IMPL=cmajor` sends the UNet's forward through the hand-written
channel-major conv kernel.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluates a trained preprocessor")
    p.add_argument("--show_txt", action="store_true")
    p.add_argument("--show_img", action="store_true")
    p.add_argument("--prep_path", required=True,
                   help="prep model checkpoint path")
    p.add_argument("--dataset", default="patch_dataset",
                   choices=["patch_dataset", "vgg", "pos", "wildreceipt",
                            "synthetic_patch", "synthetic_area"])
    p.add_argument("--ocr", default="Tesseract")
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--data_base_path", default=".")
    p.add_argument("--show_orig", action="store_true")
    p.add_argument("--batch_docs", type=int, default=2)
    p.add_argument("--max_strips", type=int, default=32)
    p.add_argument("--unet_features", type=int, default=32)
    p.add_argument("--doc_size", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="document canvas (default: config DOC_SIZE)")
    p.add_argument("--synthetic_docs", type=int, default=8)
    p.add_argument("--synthetic_size", type=int, default=64)
    p.add_argument("--synthetic_strips_per_doc", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu); a missing GPU "
                        "is an error")
    return p


def config_from_args(args):
    from qea_ocr_tpu_torch.eval.eval_prep import EvalPrepConfig

    return EvalPrepConfig(
        prep_path=args.prep_path, dataset=args.dataset, ocr=args.ocr,
        batch_size=args.batch_size, data_base_path=args.data_base_path,
        show_orig=args.show_orig, show_txt=args.show_txt,
        show_img=args.show_img, batch_docs=args.batch_docs,
        max_strips=args.max_strips, unet_features=args.unet_features,
        synthetic_docs=args.synthetic_docs,
        synthetic_size=args.synthetic_size,
        synthetic_strips_per_doc=args.synthetic_strips_per_doc,
        device=args.device,
        **({"doc_size": tuple(args.doc_size)} if args.doc_size else {}),
    )


def main(argv=None):
    from qea_ocr_tpu_torch.eval.eval_prep import EvalPrep

    args = build_parser().parse_args(argv)
    print(args)
    evaluator = EvalPrep(config_from_args(args))
    return evaluator.eval(), evaluator.original


if __name__ == "__main__":
    main()
