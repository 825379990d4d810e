"""Build a patch dataset (image + bbox JSON sidecar) from raw documents.

Counterpart of the reference's dataset-construction path: GVision
`get_labels_fullimage` word boxes (`ocr_helper/gcloud_helper.py:108-137`)
plus the `cer_data_utils/patch_image_mapping.py` strip/document key mapping.
Writes `<img>.json` sidecars in the min/max schema `PatchDocuments` reads.

CLI: python -m qea_ocr_tpu_torch.tools.build_patch_dataset --src raw/ --dst out/ \
       [--mock]

The port's own copy of `qea_ocr_tpu/tools/build_patch_dataset.py` (numpy
only): the port imports nothing of the JAX package, and
`tests/test_torch_tooling.py` holds the copy equal to its original.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil


from qea_ocr_tpu_torch.data.datasets import find_images, load_gray


def build(src: str, dst: str, backend) -> int:
    os.makedirs(dst, exist_ok=True)
    n = 0
    for path in find_images(src):
        img = load_gray(path)
        words = backend.get_labels_fullimage(img)
        sidecar = [
            dict(label=w, x_min=int(x0), y_min=int(y0),
                 x_max=int(x1), y_max=int(y1))
            for (w, (x0, y0, x1, y1)) in words
        ]
        base = os.path.basename(path)
        shutil.copy2(path, os.path.join(dst, base))
        with open(os.path.join(dst, os.path.splitext(base)[0] + ".json"),
                  "w") as f:
            json.dump(sidecar, f)
        n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Annotate raw documents into a patch dataset")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--mock", action="store_true",
                   help="use the GVision mock (offline)")
    args = p.parse_args(argv)
    from qea_ocr_tpu_torch.ocr.gvision import GVisionBackend
    backend = GVisionBackend(mock_response=args.mock)
    n = build(args.src, args.dst, backend)
    print(f"annotated {n} documents -> {args.dst}")


if __name__ == "__main__":
    main()
