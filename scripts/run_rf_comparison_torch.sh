#!/bin/bash
# Batch RF-vs-base comparison of the PyTorch/CUDA port (counterpart of
# run_rf_comparison.sh); options after the dataset and the models
# (--device, --epochs, --workdir, --journal) go to
# scripts/run_rf_models_torch.py, and --workdir to the log comparison.
GREEN='\033[0;32m'; NC='\033[0m'
DATASET=${1:-baby}
MODELS=${2:-all}
HERE=$(cd "$(dirname "$0")" && pwd)
echo -e "${GREEN}[INFO]${NC} RF comparison on $DATASET (models: $MODELS, genmmrec_tpu_torch)"
python "$HERE/run_rf_models_torch.py" --dataset "$DATASET" --models $MODELS --use_rf true false "${@:3}"
rc=$?
python "$HERE/compare_results_torch.py" --dataset "$DATASET" "${@:3}"
exit $rc
