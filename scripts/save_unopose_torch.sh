#!/bin/sh
# Run inference with the PyTorch port, write the BOP19 CSV and score it
# (counterpart of scripts/save_unopose.sh). The weights: misc.load_from, else
# the latest checkpoint under misc.output_dir/ckpt.
#   scripts/save_unopose_torch.sh [config-module:fn] [--device cpu] [overrides...]
set -e
cd "$(dirname "$0")/.."
CFG=${1:-unopose_tpu_torch.configs:main_config}
shift 2>/dev/null || true
exec python -m unopose_tpu_torch.main_unopose --config "$CFG" --eval-only "$@"
