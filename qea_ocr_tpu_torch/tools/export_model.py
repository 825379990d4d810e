"""Export a trained preprocessor as a `torch.export` artifact (counterpart of
`qea_ocr_tpu/tools/export_model.py`, whose artifact is StableHLO).

The port's UNet checkpoint is loaded into the eval-mode UNet on `--device`,
traced by `torch.export.export` for one fixed input shape (batch_size, 1, H,
W) with the weights inside, and written by `torch.export.save`. The artifact
holds ATen operations only: any process with a matching PyTorch loads and
runs it without this package.

Run: python -m qea_ocr_tpu_torch.tools.export_model --prep_path <ckpt> \\
       --out prep.pt2 [--batch_size 8] [--doc_size 400 512] [--device cuda]

Load elsewhere:
    import torch
    clean = torch.export.load("prep.pt2").module()
    cleaned = clean(images)   # (B, 1, H, W) float32 in [0, 1], on the
                              # device the artifact was exported on

The UNet is built with `conv_impl="auto"`, as the JAX tool builds it. The
channel-major conv kernel is bound through `ctypes` (`ops/cuda/build.py`),
which `torch.export` cannot trace, so when `QEA_CONV_IMPL=cmajor` selects
that route the export raises `NotImplementedError` before it writes
anything, rather than exporting the library route in its place (ROADMAP.md
Queue 1 item 10, the `torch.library` registration).
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from qea_ocr_tpu_torch import config as C
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.utils.device import resolve_device
from qea_ocr_tpu_torch.utils.io import load_checkpoint


def export_prep(prep_path: str, out_path: str, *, batch_size: int = 8,
                doc_size=None, unet_features: int = 32,
                device: str = "cuda") -> dict:
    """Write the artifact of the UNet checkpoint `prep_path` to `out_path`;
    returns what the CLI prints."""
    doc_size = tuple(doc_size or C.DOC_SIZE)
    dev = resolve_device(device)
    model = UNet(init_features=unet_features, conv_impl="auto")
    if model.conv_impl == "cmajor":
        raise NotImplementedError(
            "QEA_CONV_IMPL=cmajor: the channel-major conv kernel is called "
            "through ctypes, which torch.export cannot trace; it needs a "
            "torch.library registration first (ROADMAP.md Queue 1 item 10)")
    load_checkpoint(prep_path, model)
    model = model.to(dev).eval()
    example = torch.zeros((batch_size, 1, *doc_size), device=dev)
    with torch.no_grad():
        exported = torch.export.export(model, (example,))
    torch.export.save(exported, out_path)
    return {"out": out_path, "bytes": os.path.getsize(out_path),
            "input_shape": [batch_size, 1, *doc_size], "device": str(dev),
            "conv_impl": model.conv_impl}


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
