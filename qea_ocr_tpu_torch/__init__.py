"""qea_ocr_tpu_torch — the PyTorch/CUDA port of qea_ocr_tpu.

The JAX package `qea_ocr_tpu` stays the reference; this package mirrors its
layout module for module and keeps its own copies of the numpy-only host
modules it needs (config, charmap, data, ocr, label history, the state_dict
mapping). It imports neither `jax` nor anything of `qea_ocr_tpu`.

It does all that the JAX package does: serving (`serve.cleaner`,
`cli.clean_docs`), the patch trainer (`train.patch_trainer`,
`cli.patch_cli`), the CRNN warmup, both evaluators, the CER seed, the
quality runs of both trainers (`tools.quality_run`,
`tools.quality_run_area`), the area (word-crop) trainer
(`train.area_trainer`, `cli.area_cli`), the CTC loss with per-row valid
steps (`ops.ctc`, `logit_lengths`), GPU launchers (`launch/*.sh`) and
console scripts (`qea-torch-*`), the `torch.export` artifact of a trained UNet
(`tools.export_model`), the import of the reference's own checkpoints
(`tools.import_torch`), data and tensor parallelism over
`torch.distributed`, one process a GPU (`parallel`), dataset pruning
(`pruning`, `tools.prune_cli`), CER analysis, sweeps (`sweeps`), the real
OCR back ends and the dataset builder. Left out: the TPU-only helpers
(`ops/s2d.py`, `utils/platform.py`, `utils/pair_cache.py`) and the test
oracles, which the tests take from the JAX package. Every TPU kernel has a
hand-written CUDA counterpart in `csrc/`, built with `nvcc` at first use
(`ops/cuda/build.py`); the channel-major conv is also a custom operator,
`torch.ops.qea_ocr.conv_flat`, registered by `ops/conv_cmajor.py`.
"""

__version__ = "0.1.0"
