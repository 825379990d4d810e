#!/usr/bin/env bash
# Sweep job-array launcher for the PyTorch port: counterpart of
# scripts/run_sweep_array.sh (reference compute_canada/run_*_sweep.sh +
# run_nn_patch_training_array.sh): N parallel workers, one optuna trial
# each, coordinated through a shared sqlite RDB like the reference's
# SLURM-array pattern. Every worker runs on DEVICE (default cuda: the
# first visible GPU; cpu for the CPU).
set -euo pipefail
N=${N:-4}
DB=${DB:-sqlite:///$PWD/sweep.db}
DEVICE=${DEVICE:-cuda}

for i in $(seq 1 "$N"); do
  python -m qea_ocr_tpu_torch.sweeps.sweep --which patch --n_trials 1 \
    --storage "$DB" --study_name qea_patch_sweep \
    --device "$DEVICE" "$@" &
done
wait
