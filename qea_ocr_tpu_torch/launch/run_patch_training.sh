#!/usr/bin/env bash
# GPU launcher for budget-aware patch training with the PyTorch port.
#
# Counterpart of scripts/run_patch_training.sh, with its knobs, defaults and
# fixed flags, and of reference `compute_canada/run_nn_patch_training.sh`
# (SLURM / single V100). One GPU as it is; DEVICE=cpu runs on the CPU.
# NPROC=N > 1 runs N processes on N GPUs of this host under torchrun with
# --data_parallel: the trainer pins a per-process document subset, fans the
# OCR out per process and shards the global batch over all GPUs. Across
# hosts, start one process per GPU with QEA_DISTRIBUTED=1
# QEA_COORDINATOR=host:port QEA_NUM_PROCESSES=N QEA_PROCESS_ID=i and pass
# --data_parallel.
#
# The 4% POS query budget corresponds to --minibatch_subset_prop 0.95
# (reference README.md:34); 8% ~ 0.87.
set -euo pipefail

DATA=${DATA:-$PWD/data}
EXP=${EXP:-$PWD/exp_out/patch_$(date +%Y%m%d_%H%M%S)}
OCR=${OCR:-Tesseract}
BUDGET_PROP=${BUDGET_PROP:-0.95}
DEVICE=${DEVICE:-cuda}
NPROC=${NPROC:-1}

if [ "$NPROC" -gt 1 ]; then
  launch=(torchrun --nproc_per_node "$NPROC" -m)
  parallel=(--data_parallel)
else
  launch=(python -m)
  parallel=()
fi

"${launch[@]}" qea_ocr_tpu_torch.cli.patch_cli \
  --data_base_path "$DATA" \
  --exp_base_path "$EXP" \
  --ocr "$OCR" \
  --minibatch_subset rangeCER \
  --minibatch_subset_prop "$BUDGET_PROP" \
  --inner_limit 2 --inner_limit_skip \
  --window_size 3 --weightgen_method decaying \
  --cers_ocr_path "$DATA/pos_dataset_cers.json" \
  --batch_docs 8 --max_strips 32 \
  --device "$DEVICE" "${parallel[@]}" \
  --epoch 50 "$@"
