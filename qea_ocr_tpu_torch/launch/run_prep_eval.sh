#!/usr/bin/env bash
# Prep-evaluation launcher for the PyTorch port: counterpart of
# scripts/run_prep_eval.sh (reference compute_canada/run_prep_eval*.sh).
# Evaluates one or more checkpoints one after another, on one GPU
# (DEVICE=cpu: on the CPU).
set -euo pipefail
DATA=${DATA:-$PWD/data}
OCR=${OCR:-Tesseract}
DEVICE=${DEVICE:-cuda}

for ckpt in "$@"; do
  echo "== $ckpt =="
  python -m qea_ocr_tpu_torch.cli.eval_prep \
    --data_base_path "$DATA" --ocr "$OCR" \
    --dataset patch_dataset --show_orig \
    --device "$DEVICE" \
    --prep_path "$ckpt"
done
