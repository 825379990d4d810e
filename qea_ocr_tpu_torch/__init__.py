"""qea_ocr_tpu_torch — the PyTorch/CUDA port of qea_ocr_tpu.

The JAX package `qea_ocr_tpu` stays the reference; this package mirrors its
layout module for module and keeps its own copies of the numpy-only host
modules it needs (config, charmap, data, ocr, label history, the state_dict
mapping). It imports neither `jax` nor anything of `qea_ocr_tpu`.

Ported so far: serving (`serve.cleaner`, `cli.clean_docs`), the patch trainer
(`train.patch_trainer`, `cli.patch_cli`), the CRNN warmup, both evaluators,
the CER seed and the quality run, the area (word-crop) trainer
(`train.area_trainer`, `cli.area_cli`), the `torch.export` artifact of a
trained UNet (`tools.export_model`), the import of the reference's own
checkpoints (`tools.import_torch`), and data and tensor parallelism over
`torch.distributed`, one process a GPU (`parallel`). Every TPU kernel has a hand-written CUDA
counterpart in `csrc/`, built with `nvcc` at first use (`ops/cuda/build.py`).
"""

__version__ = "0.1.0"
