"""Textarea-training CLI (counterpart of `qea_ocr_tpu/cli/area_cli.py`):
flag for flag the JAX package's, which is the reference's
`area_cli.py:10-124` plus --dataset synthetic for hermetic runs, and
`--proxy` (`crnn` or `svtr-l`, `models/proxy.py`) and `--device`.

Run: python -m qea_ocr_tpu_torch.cli.area_cli --ocr Fake --dataset synthetic ...

`--data_parallel` shards the crop batch over the processes of a
`torch.distributed` group, one GPU each: `torchrun --nproc_per_node N -m
qea_ocr_tpu_torch.cli.area_cli --data_parallel ...`, or the `QEA_*`
variables of `parallel.multihost.maybe_init_distributed`, which `main`
calls before the trainer is built.
"""

from __future__ import annotations

import argparse
import datetime
import os

from qea_ocr_tpu_torch.config import SELECTION_KEYS, WEIGHTGEN_KEYS


def build_parser() -> argparse.ArgumentParser:
    from qea_ocr_tpu_torch.models.proxy import PROXIES

    p = argparse.ArgumentParser(
        description="Trains the Prep (UNet) with text-area word crops")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr_crnn", type=float, default=0.0001)
    p.add_argument("--lr_prep", type=float, default=0.00005)
    p.add_argument("--scalar", type=float, default=1)
    p.add_argument("--epoch", type=int, default=25)
    p.add_argument("--random_seed", type=int, default=42)
    p.add_argument("--std", type=int, default=5)
    p.add_argument("--inner_limit", type=int, default=2)
    p.add_argument("--inner_limit_skip", action="store_true")
    p.add_argument("--crnn_model")
    p.add_argument("--prep_model")
    p.add_argument("--exp_base_path", default=".")
    p.add_argument("--ocr", default="Tesseract")
    p.add_argument("--dataset", default="pos", choices=["pos", "vgg", "synthetic"])
    p.add_argument("--random_std", action="store_false", default=True)
    p.add_argument("--minibatch_subset",
                   choices=list(SELECTION_KEYS))
    p.add_argument("--minibatch_subset_prop", default=0.5, type=float)
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--data_base_path", default=".")
    p.add_argument("--warmup_epochs", type=int, default=0)
    p.add_argument("--exp_name", default="test_area")
    p.add_argument("--exp_id")
    p.add_argument("--train_subset_size", type=int)
    p.add_argument("--val_subset_size", type=int)
    p.add_argument("--cers_ocr_path")
    p.add_argument("--update_CRNN", action="store_true")
    p.add_argument("--window_size", type=int, default=1)
    p.add_argument("--query_dim", type=int, default=32)
    p.add_argument("--emb_dim", type=int, default=256)
    p.add_argument("--attn_activation", default="sigmoid",
                   choices=["sigmoid", "softmax", "relu"])
    p.add_argument("--weightgen_method", default="decaying",
                   choices=list(WEIGHTGEN_KEYS))
    p.add_argument("--decay_factor", type=float, default=0.7)
    p.add_argument("--discount_factor", type=float, default=1)
    p.add_argument("--lr_scheduler", choices=["cosine"])
    p.add_argument("--lr_scheduler_prep", choices=["cosine"])
    p.add_argument("--synthetic_train_size", type=int, default=128)
    p.add_argument("--synthetic_val_size", type=int, default=32)
    p.add_argument("--prep_pretrain_epochs", type=int, default=0,
                   help="identity/denoise UNet pretraining epochs")
    p.add_argument("--prep_pretrain_lr", type=float, default=1e-3)
    p.add_argument("--prep_ema", type=float, default=0.0,
                   help=">0: validate/checkpoint an EMA of the prep params "
                        "(drift countermeasure; e.g. 0.99)")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard the crop batch over the processes of the "
                        "process group, one GPU each")
    p.add_argument("--lstm_hidden", type=int, default=256,
                   help="CRNN BiLSTM hidden size (reference fixes 256)")
    p.add_argument("--unet_features", type=int, default=32,
                   help="UNet level-1 feature count (reference fixes 32)")
    p.add_argument("--proxy", default="crnn", choices=PROXIES,
                   help="the differentiable OCR proxy: crnn (the reference's "
                        "CRNN, T=31 CTC steps) or svtr-l (SVTR-L, T=32 "
                        "steps)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu); a missing GPU "
                        "is an error, not a fallback")
    return p


def config_from_args(args):
    from qea_ocr_tpu_torch.cli import config_from_args as fill
    from qea_ocr_tpu_torch.train.area_trainer import AreaTrainerConfig

    return fill(AreaTrainerConfig, args)


def main(argv=None):
    """Train as the flags say; returns the trainer (its models, tables and
    query ledger)."""
    from qea_ocr_tpu_torch.parallel.multihost import (
        maybe_init_distributed, process_shard)
    from qea_ocr_tpu_torch.train.area_trainer import TrainNNPrepArea

    args = build_parser().parse_args(argv)
    print("Training Arguments")
    print(args)
    maybe_init_distributed(args.device)
    trainer = TrainNNPrepArea(config_from_args(args))
    start = datetime.datetime.now()
    trainer.train()
    end = datetime.datetime.now()
    if process_shard()[0] == 0:
        with open(os.path.join(args.exp_base_path, "params.txt"), "w") as f:
            f.write(f"{start}\n{args}\n{end}\n")
    return trainer


if __name__ == "__main__":
    main()
