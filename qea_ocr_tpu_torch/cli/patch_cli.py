"""Patch-training CLI (counterpart of `qea_ocr_tpu/cli/patch_cli.py`): flag
for flag the JAX package's, which is the reference's `patch_cli.py:10-156`
plus the batched additions (--batch_docs, --max_strips, --dataset synthetic
for hermetic runs), and `--proxy` (`crnn` or `svtr-l`,
`models/proxy.py`) and `--device`.

Run: python -m qea_ocr_tpu_torch.cli.patch_cli --ocr Fake --dataset synthetic ...

`--pruning_artifact` (a `tools/prune_cli` JSON) trains on the artifact's
documents only. `QEA_CONV_IMPL=cmajor`
sends the trainer's no-grad UNet forwards through the hand-written
channel-major conv kernel.

Several processes, one a GPU: `torchrun --nproc_per_node N -m
qea_ocr_tpu_torch.cli.patch_cli --data_parallel ...` (or
`--tensor_parallel T`), or the JAX package's variables `QEA_DISTRIBUTED=1
QEA_COORDINATOR=host:port QEA_NUM_PROCESSES=N QEA_PROCESS_ID=r` in each
process. `main` makes the process group (`parallel.multihost.
maybe_init_distributed`: NCCL for `--device cuda`, Gloo for `cpu`) before
the trainer is built, and keeps it.
"""

from __future__ import annotations

import argparse
import datetime
import os

from qea_ocr_tpu_torch.config import SELECTION_KEYS, WEIGHTGEN_KEYS


def build_parser() -> argparse.ArgumentParser:
    from qea_ocr_tpu_torch.models.proxy import PROXIES

    p = argparse.ArgumentParser(
        description="Trains the Prep (UNet) with the Patch dataset")
    p.add_argument("--lr_crnn", type=float, default=0.0001,
                   help="CRNN learning rate")
    p.add_argument("--scalar", type=float, default=1,
                   help="scalar multiplying the secondary (MSE-to-white) loss")
    p.add_argument("--lr_prep", type=float, default=0.00005,
                   help="prep model learning rate")
    p.add_argument("--epoch", type=int, default=25, help="number of epochs")
    p.add_argument("--random_seed", type=int, default=42)
    p.add_argument("--std", type=int, default=5,
                   help="gaussian jitter std (divided by 100)")
    p.add_argument("--inner_limit", type=int, default=2,
                   help="inner loop iterations")
    p.add_argument("--inner_limit_skip", action="store_true",
                   help="first inner loop runs label tracking (no noise)")
    p.add_argument("--crnn_model", help="CRNN checkpoint to load")
    p.add_argument("--prep_model", help="Prep checkpoint to load")
    p.add_argument("--exp_base_path", default=".")
    p.add_argument("--ocr", default="Tesseract",
                   help="black-box OCR [Tesseract,EasyOCR,gvision,Fake]")
    p.add_argument("--random_std", action="store_false", default=True,
                   help="per-image std drawn from [0, std]")
    p.add_argument("--minibatch_subset",
                   choices=list(SELECTION_KEYS),
                   help="query-budget selection strategy")
    p.add_argument("--minibatch_subset_prop", default=0.5, type=float,
                   help="fraction of samples NOT queried per minibatch")
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--data_base_path", default=".")
    p.add_argument("--warmup_epochs", type=int, default=0)
    p.add_argument("--exp_name", default="test_patch")
    p.add_argument("--exp_id")
    p.add_argument("--train_subset_size", type=int)
    p.add_argument("--val_subset_size", type=int)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--cers_ocr_path", help="CER seed json")
    p.add_argument("--image_prop", type=float,
                   help="fraction of images per epoch")
    p.add_argument("--discount_factor", type=float, default=1)
    p.add_argument("--update_CRNN", action="store_true",
                   help="update CRNN during the prep phase too")
    p.add_argument("--window_size", type=int, default=1)
    p.add_argument("--query_dim", type=int, default=32)
    p.add_argument("--emb_dim", type=int, default=256)
    p.add_argument("--attn_activation", default="sigmoid",
                   choices=["sigmoid", "softmax", "relu"])
    p.add_argument("--weightgen_method", default="decaying",
                   choices=list(WEIGHTGEN_KEYS))
    p.add_argument("--decay_factor", type=float, default=0.7)
    p.add_argument("--optim_crnn_path",
                   help="checkpoint to fully resume CRNN params+optimizer from")
    p.add_argument("--optim_prep_path")
    p.add_argument("--pruning_artifact")
    p.add_argument("--tracked_labels_path",
                   help="resume label history from a tracked_labels json")
    p.add_argument("--profile_dir", help="write a torch.profiler trace here")
    p.add_argument("--prep_pretrain_epochs", type=int, default=0,
                   help="identity/denoise UNet pretraining epochs")
    p.add_argument("--prep_ema", type=float, default=0.0,
                   help=">0: validate/checkpoint an EMA of the prep params "
                        "(decay=this value) instead of the raw training "
                        "params: filters co-adaptation drift out of the "
                        "deployed artifact")
    # batched additions
    p.add_argument("--batch_docs", type=int, default=1,
                   help="documents per device step (reference fixes 1)")
    p.add_argument("--micro_steps", type=int, default=1,
                   help="sequential optimizer micro-steps per batch: split "
                        "each batch_docs batch into this many chunks inside "
                        "the step, one phase-A + phase-B update per chunk: "
                        "reference bs=1 step dynamics at batched "
                        "amortization (must divide batch_docs)")
    p.add_argument("--micro_refresh", action="store_true",
                   help="with --micro_steps: re-extract phase-A history "
                        "strips from the current prep inside each chunk "
                        "(reference per-doc freshness; needed for "
                        "stability at chunk sizes near 1)")
    p.add_argument("--max_strips", type=int, default=32)
    p.add_argument("--dataset", default="patch", choices=["patch", "synthetic"])
    p.add_argument("--synthetic_train_docs", type=int, default=32)
    p.add_argument("--synthetic_val_docs", type=int, default=8)
    p.add_argument("--synthetic_strips_per_doc", type=int, default=6)
    p.add_argument("--doc_size", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="document canvas (default: config DOC_SIZE)")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--async_ocr", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="pipeline host OCR over device compute (default on; "
                        "--no-async_ocr restores reference-exact synchronous "
                        "querying)")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard document batches over the processes of the "
                        "process group, one GPU each")
    p.add_argument("--lstm_hidden", type=int, default=256,
                   help="CRNN BiLSTM hidden size (reference fixes 256)")
    p.add_argument("--unet_features", type=int, default=32,
                   help="UNet level-1 feature count (reference fixes 32)")
    p.add_argument("--tensor_parallel", type=int, default=0,
                   help="model-axis size T of a 2-D (data x model) mesh "
                        "over the processes: params + optimizer moments "
                        "stored sharded over T processes, batch sharded "
                        "over the data axis")
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
    from qea_ocr_tpu_torch.train.patch_trainer import PatchTrainerConfig

    return fill(PatchTrainerConfig, args)


def main(argv=None):
    """Train as the flags say; returns the trainer (its models, tables,
    query ledger and the losses of every step)."""
    from qea_ocr_tpu_torch.parallel.multihost import (
        maybe_init_distributed, process_shard)
    from qea_ocr_tpu_torch.train.patch_trainer import TrainNNPrep

    args = build_parser().parse_args(argv)
    print("Training Arguments")
    print(args)
    maybe_init_distributed(args.device)
    cfg = config_from_args(args)
    trainer = TrainNNPrep(cfg)
    start = datetime.datetime.now()
    trainer.train()
    end = datetime.datetime.now()
    if process_shard()[0] == 0:
        with open(os.path.join(args.exp_base_path, "params.txt"), "w") as f:
            f.write(f"{start}\n{args}\n{end}\n")
    return trainer


if __name__ == "__main__":
    main()
