"""CRNN-evaluation CLI (counterpart of `qea_ocr_tpu/cli/eval_crnn.py`): flag
for flag the JAX package's, which is the reference's `eval_crnn.py`
__main__, plus `--device`.

Run: python -m qea_ocr_tpu_torch.cli.eval_crnn --crnn_path <dir> \
       --crnn_model_name CRNN_model_0 --dataset synthetic_area --ocr Fake
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluates a trained CRNN proxy")
    p.add_argument("--show_txt", action="store_true")
    p.add_argument("--show_img", action="store_true")
    p.add_argument("--crnn_path", default=".", help="checkpoint directory")
    p.add_argument("--crnn_model_name", required=True)
    p.add_argument("--dataset", default="pos_textarea",
                   choices=["vgg", "pos", "pos_textarea",
                            "synthetic_patch", "synthetic_area"])
    p.add_argument("--ocr", default="Tesseract")
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--data_base_path", default=".")
    p.add_argument("--show_orig", action="store_true")
    p.add_argument("--batch_docs", type=int, default=2)
    p.add_argument("--max_strips", type=int, default=32)
    p.add_argument("--lstm_hidden", type=int, default=256)
    p.add_argument("--doc_size", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="document canvas (default: config DOC_SIZE)")
    p.add_argument("--synthetic_docs", type=int, default=8)
    p.add_argument("--synthetic_size", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu); a missing GPU "
                        "is an error")
    return p


def config_from_args(args):
    from qea_ocr_tpu_torch.eval.eval_crnn import EvalCrnnConfig

    return EvalCrnnConfig(
        crnn_path=args.crnn_path, crnn_model_name=args.crnn_model_name,
        dataset=args.dataset, ocr=args.ocr, batch_size=args.batch_size,
        data_base_path=args.data_base_path, show_orig=args.show_orig,
        show_txt=args.show_txt, show_img=args.show_img,
        batch_docs=args.batch_docs, max_strips=args.max_strips,
        lstm_hidden=args.lstm_hidden,
        synthetic_docs=args.synthetic_docs,
        synthetic_size=args.synthetic_size, device=args.device,
        **({"doc_size": tuple(args.doc_size)} if args.doc_size else {}),
    )


def main(argv=None):
    from qea_ocr_tpu_torch.eval.eval_crnn import EvalCRNN

    args = build_parser().parse_args(argv)
    print(args)
    return EvalCRNN(config_from_args(args)).eval()


if __name__ == "__main__":
    main()
