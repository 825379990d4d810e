#!/usr/bin/env bash
# GPU launcher for budget-aware textarea (word-crop) training with the
# PyTorch port.
#
# Counterpart of scripts/run_area_training.sh, with its knobs, defaults and
# fixed flags, and of reference `compute_canada/run_nn_area_training.sh`
# (SLURM / single V100; 4% VGG budget = --minibatch_subset_prop 0.93,
# reference run_nn_area_training.sh:42). One GPU as it is; DEVICE=cpu runs
# on the CPU. NPROC=N > 1 runs N processes on N GPUs of this host under
# torchrun with --data_parallel (the crop batch sharded over them); across
# hosts, start one process per GPU with QEA_DISTRIBUTED=1
# QEA_COORDINATOR=host:port QEA_NUM_PROCESSES=N QEA_PROCESS_ID=i and pass
# --data_parallel.
set -euo pipefail

DATA=${DATA:-$PWD/data}
EXP=${EXP:-$PWD/exp_out/area_$(date +%Y%m%d_%H%M%S)}
OCR=${OCR:-Tesseract}
BUDGET_PROP=${BUDGET_PROP:-0.93}
DEVICE=${DEVICE:-cuda}
NPROC=${NPROC:-1}

if [ "$NPROC" -gt 1 ]; then
  launch=(torchrun --nproc_per_node "$NPROC" -m)
  parallel=(--data_parallel)
else
  launch=(python -m)
  parallel=()
fi

"${launch[@]}" qea_ocr_tpu_torch.cli.area_cli \
  --data_base_path "$DATA" \
  --exp_base_path "$EXP" \
  --ocr "$OCR" \
  --minibatch_subset rangeCER \
  --minibatch_subset_prop "$BUDGET_PROP" \
  --inner_limit 2 --inner_limit_skip \
  --window_size 3 --weightgen_method decaying \
  --cers_ocr_path "$DATA/all_cers_textarea.json" \
  --batch_size 64 \
  --device "$DEVICE" "${parallel[@]}" \
  --epoch 50 "$@"
