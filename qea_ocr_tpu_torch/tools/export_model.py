"""Export a trained preprocessor as a `torch.export` artifact (counterpart of
`qea_ocr_tpu/tools/export_model.py`, whose artifact is StableHLO).

The port's UNet checkpoint is loaded into the eval-mode UNet on `--device`,
traced by `torch.export.export` for one fixed input shape (batch_size, 1, H,
W) with the weights inside, and written by `torch.export.save`.

The UNet is built with `conv_impl="auto"`, as the JAX tool builds it. On the
library route an artifact exported on the CPU holds ATen operations only:
any process with a matching PyTorch loads and runs it without this package.
Exported on CUDA, it holds one `torch.ops.qea_ocr.bn_relu_eval` node a batch
norm + ReLU (18), so that it runs the hand-written kernels of
`ops/bn_relu.py`: a process loads it only after it has registered that
operator (`import qea_ocr_tpu_torch.ops.bn_relu`, which needs this package's
ops and parallel modules and the kernel's CUDA source, not its models,
trainers or serving). With `QEA_CONV_IMPL=cmajor` the shallow levels take
the channel-major route, and the artifact holds one
`torch.ops.qea_ocr.conv_flat` node a conv (8 for the four padded-flat
blocks; `QEA_CMAJOR_FUSED`, read while tracing, says whether each folds its
batch norm and ReLU): a process loads it only after it has registered that
operator, which needs this package's `ops/conv_cmajor.py` and its CUDA
kernel source, and nothing else of it.

Run: python -m qea_ocr_tpu_torch.tools.export_model --prep_path <ckpt> \\
       --out prep.pt2 [--batch_size 8] [--doc_size 400 512] [--device cuda]

Load elsewhere:
    import torch
    import qea_ocr_tpu_torch.ops.conv_cmajor  # only for a cmajor artifact
    import qea_ocr_tpu_torch.ops.bn_relu      # only for one exported on CUDA
    clean = torch.export.load("prep.pt2").module()
    cleaned = clean(images)   # (B, 1, H, W) float32 in [0, 1], on the
                              # device the artifact was exported on
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from qea_ocr_tpu_torch import config as C
from qea_ocr_tpu_torch.models.unet import UNet, fused_by_env
from qea_ocr_tpu_torch.utils.device import resolve_device
from qea_ocr_tpu_torch.utils.io import load_checkpoint


def _nodes(exported, target) -> int:
    return sum(n.op == "call_function" and n.target == target
               for n in exported.graph.nodes)


def conv_flat_nodes(exported) -> int:
    """How many `qea_ocr::conv_flat` calls the exported graph holds (the
    operator is registered by `ops/conv_cmajor.py`, which the UNet
    imports)."""
    return _nodes(exported, torch.ops.qea_ocr.conv_flat.default)


def bn_relu_nodes(exported) -> int:
    """How many `qea_ocr::bn_relu_eval` calls the exported graph holds
    (registered by `ops/bn_relu.py`, which the UNet imports)."""
    return _nodes(exported, torch.ops.qea_ocr.bn_relu_eval.default)


def export_prep(prep_path: str, out_path: str, *, batch_size: int = 8,
                doc_size=None, unet_features: int = 32,
                device: str = "cuda") -> dict:
    """Write the artifact of the UNet checkpoint `prep_path` to `out_path`;
    returns what the CLI prints."""
    doc_size = tuple(doc_size or C.DOC_SIZE)
    dev = resolve_device(device)
    model = UNet(init_features=unet_features, conv_impl="auto")
    load_checkpoint(prep_path, model)
    model = model.to(dev).eval()
    example = torch.zeros((batch_size, 1, *doc_size), device=dev)
    with torch.no_grad():
        exported = torch.export.export(model, (example,))
    torch.export.save(exported, out_path)
    return {"out": out_path, "bytes": os.path.getsize(out_path),
            "input_shape": [batch_size, 1, *doc_size], "device": str(dev),
            "conv_impl": model.conv_impl,
            "cmajor_fused": (fused_by_env() if model.conv_impl == "cmajor"
                             else None),
            "conv_flat_nodes": conv_flat_nodes(exported),
            "bn_relu_nodes": bn_relu_nodes(exported)}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Export a trained prep model with torch.export")
    p.add_argument("--prep_path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--doc_size", type=int, nargs=2, default=None,
                   metavar=("H", "W"))
    p.add_argument("--unet_features", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu); a missing GPU "
                        "is an error, not a fallback")
    args = p.parse_args(argv)
    info = export_prep(args.prep_path, args.out, batch_size=args.batch_size,
                       doc_size=args.doc_size,
                       unet_features=args.unet_features, device=args.device)
    print(json.dumps(info))
    return info


if __name__ == "__main__":
    main()
