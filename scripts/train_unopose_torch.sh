#!/bin/sh
# Train with the PyTorch port on one CUDA card (counterpart of scripts/train_unopose.sh).
#   scripts/train_unopose_torch.sh [config-module:fn] [--synthetic-data] [--device cpu] [overrides...]
# Resumes from the latest checkpoint under misc.output_dir/ckpt when one exists.
set -e
cd "$(dirname "$0")/.."
CFG=${1:-unopose_tpu_torch.configs:main_config}
shift 2>/dev/null || true
exec python -m unopose_tpu_torch.main_unopose --config "$CFG" "$@"
