#!/bin/sh
# Train with the PyTorch port on one CUDA card, or on N (counterpart of scripts/train_unopose.sh).
#   scripts/train_unopose_torch.sh [config-module:fn] [--synthetic-data] [--device cpu] [--num-devices N] [overrides...]
# On N cards under torchrun (NCCL, one rank a card, misc.train_batch_size split over the ranks):
#   torchrun --nproc_per_node N -m unopose_tpu_torch.main_unopose --config unopose_tpu_torch.configs:main_config ...
# Resumes from the latest checkpoint under misc.output_dir/ckpt when one exists.
set -e
cd "$(dirname "$0")/.."
CFG=${1:-unopose_tpu_torch.configs:main_config}
shift 2>/dev/null || true
exec python -m unopose_tpu_torch.main_unopose --config "$CFG" "$@"
