#!/bin/bash
# DiffMM vs RFMRec comparison of the PyTorch/CUDA port (counterpart of
# run_comparison.sh); options after the dataset (--device, --epochs,
# --workdir, --journal) go to scripts/compare_models_torch.py.
DATASET=${1:-baby}
HERE=$(cd "$(dirname "$0")" && pwd)
echo "=============================================="
echo "  DiffMM vs RFMRec comparison on $DATASET (genmmrec_tpu_torch)"
echo "=============================================="
python "$HERE/compare_models_torch.py" --models DiffMM RFMRec --dataset "$DATASET" "${@:2}"
rc=$?
echo "Done."
exit $rc
