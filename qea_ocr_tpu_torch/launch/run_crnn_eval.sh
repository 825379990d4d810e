#!/usr/bin/env bash
# CRNN (proxy) evaluation launcher for the PyTorch port: counterpart of
# scripts/run_crnn_eval.sh (reference `compute_canada/run_crnn_eval.sh`).
# Scores the proxy's own decoded predictions against GT (and
# OCR-on-original with --show_orig), one checkpoint after another, on one
# GPU (DEVICE=cpu: on the CPU). Each argument is a checkpoint file; the
# CLI takes its directory and its name apart (--crnn_path and the required
# --crnn_model_name, which the JAX script does not pass).
set -euo pipefail
DATA=${DATA:-$PWD/data}
OCR=${OCR:-Tesseract}
DEVICE=${DEVICE:-cuda}

for ckpt in "$@"; do
  echo "== $ckpt =="
  python -m qea_ocr_tpu_torch.cli.eval_crnn \
    --data_base_path "$DATA" --ocr "$OCR" \
    --dataset vgg \
    --device "$DEVICE" \
    --crnn_path "$(dirname "$ckpt")" \
    --crnn_model_name "$(basename "$ckpt")"
done
