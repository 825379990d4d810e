"""CRNN warmup CLI (counterpart of `qea_ocr_tpu/cli/train_crnn.py`): flag
for flag the JAX package's, which is the reference's `train_crnn.py:219-272`
plus --dataset synthetic, and `--proxy` (`crnn` or `svtr-l`,
`models/proxy.py`: the warmup trains that proxy) and `--device`.

Run: python -m qea_ocr_tpu_torch.cli.train_crnn --ocr Fake --dataset synthetic ...

`--data_parallel` shards the crop batch over the processes of a
`torch.distributed` group, one GPU each: `torchrun --nproc_per_node N -m
qea_ocr_tpu_torch.cli.train_crnn --data_parallel ...`, or the `QEA_*`
variables of `parallel.multihost.maybe_init_distributed`, which `main`
calls before the trainer is built.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    from qea_ocr_tpu_torch.models.proxy import PROXIES

    p = argparse.ArgumentParser(description="Trains the CRNN proxy model")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--epoch", type=int, default=50)
    p.add_argument("--std", type=int, default=5,
                   help="gaussian jitter std (divided by 100)")
    p.add_argument("--random_seed", type=int, default=42)
    p.add_argument("--ocr",
                   help="train on labels from this OCR [Tesseract,EasyOCR,Fake]")
    p.add_argument("--train_subset", type=int)
    p.add_argument("--val_subset", type=int)
    p.add_argument("--dataset", default="pos",
                   choices=["pos", "vgg", "synthetic"])
    p.add_argument("--random_std", action="store_false", default=True)
    p.add_argument("--crnn_model_path",
                   default="./outputs/crnn_trained_model/model",
                   help="checkpoint save prefix")
    p.add_argument("--data_base_path", default=".")
    p.add_argument("--ckpt_path", help="checkpoint to resume from")
    p.add_argument("--start_epoch", type=int, default=-1)
    p.add_argument("--synthetic_train_size", type=int, default=256)
    p.add_argument("--synthetic_val_size", type=int, default=64)
    p.add_argument("--lstm_hidden", type=int, default=256,
                   help="CRNN BiLSTM hidden size (reference fixes 256)")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard the crop batch over the processes of the "
                        "process group, one GPU each")
    p.add_argument("--proxy", default="crnn", choices=PROXIES,
                   help="the differentiable OCR proxy: crnn (the reference's "
                        "CRNN, T=31 CTC steps) or svtr-l (SVTR-L, T=32 "
                        "steps)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu); a missing GPU "
                        "is an error")
    return p


def config_from_args(args):
    from qea_ocr_tpu_torch.train.crnn_trainer import CrnnTrainerConfig

    return CrnnTrainerConfig(
        batch_size=args.batch_size, lr=args.lr, epochs=args.epoch,
        std=args.std, random_std=args.random_std,
        random_seed=args.random_seed, ocr=args.ocr, dataset=args.dataset,
        data_base_path=args.data_base_path, train_subset=args.train_subset,
        val_subset=args.val_subset, crnn_model_path=args.crnn_model_path,
        ckpt_path=args.ckpt_path, start_epoch=args.start_epoch,
        synthetic_train_size=args.synthetic_train_size,
        synthetic_val_size=args.synthetic_val_size,
        lstm_hidden=args.lstm_hidden, data_parallel=args.data_parallel,
        proxy=args.proxy, device=args.device,
    )


def main(argv=None):
    from qea_ocr_tpu_torch.parallel.multihost import maybe_init_distributed
    from qea_ocr_tpu_torch.train.crnn_trainer import TrainCRNN

    args = build_parser().parse_args(argv)
    print("Experiment Arguments")
    print(args)
    maybe_init_distributed(args.device)
    trainer = TrainCRNN(config_from_args(args))
    best_acc, best_epoch = trainer.train()
    print(f"Best val acc {best_acc * 100:.2f} @ epoch {best_epoch}")
    return trainer


if __name__ == "__main__":
    main()
