"""qea_ocr_tpu_torch — the PyTorch/CUDA port of qea_ocr_tpu.

The JAX package `qea_ocr_tpu` stays the reference; this package mirrors its
layout module for module and imports its numpy-only host modules (config,
charmap, data, ocr, the state_dict exporter) rather than copying them. It
never imports `jax`.

Ported so far: the inference slice — the UNet document cleaner and the CRNN
proxy, strip extraction, CTC loss and greedy decode, device CER and entropy,
the validation forward of the patch trainer, and the serving path
(`serve.cleaner.DocumentCleaner`, `cli.clean_docs`). The two TPU kernels on
that path run as hand-written CUDA kernels (`csrc/`), built with `nvcc` at
first use (`ops/cuda/build.py`).
"""

__version__ = "0.1.0"
