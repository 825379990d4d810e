#!/usr/bin/env bash
# CRNN-warmup launcher for the PyTorch port: counterpart of
# scripts/run_crnn_warmup.sh (reference compute_canada/run_crnn_warmup.sh),
# with its knobs, defaults and fixed flags. One GPU as it is; DEVICE=cpu
# runs on the CPU. NPROC=N > 1 runs N processes on N GPUs of this host
# under torchrun with --data_parallel; across hosts, one process per GPU
# with QEA_DISTRIBUTED=1 QEA_COORDINATOR=host:port QEA_NUM_PROCESSES=N
# QEA_PROCESS_ID=i and --data_parallel.
set -euo pipefail
DATA=${DATA:-$PWD/data}
OUT=${OUT:-$PWD/outputs/crnn_trained_model/model}
OCR=${OCR:-Tesseract}
DEVICE=${DEVICE:-cuda}
NPROC=${NPROC:-1}

if [ "$NPROC" -gt 1 ]; then
  launch=(torchrun --nproc_per_node "$NPROC" -m)
  parallel=(--data_parallel)
else
  launch=(python -m)
  parallel=()
fi

"${launch[@]}" qea_ocr_tpu_torch.cli.train_crnn \
  --data_base_path "$DATA" \
  --crnn_model_path "$OUT" \
  --ocr "$OCR" --dataset pos \
  --device "$DEVICE" "${parallel[@]}" \
  --batch_size 64 --epoch 50 "$@"
