#!/bin/bash
# The five harness runs of the PyTorch/CUDA port at one dataset, seven
# harness processes at once on one card, into one journal
# (comparison_logs/harness_torch_<ds>.json unless JOURNAL is set), then
# docs/HARNESS_RESULTS_TORCH.md by scripts/harness_report_torch.py:
#   - the four prior-guidance ablations of RFGUME, one process each;
#   - the RF comparison of RFBM3 at 50 epochs, then its landscape (use_rf false);
#   - DiffMM against RFMRec, then DiffMM's landscape;
#   - the staged search of RFGUME at 5 epochs.
# Each process has its own work directory under WORK (default harness_torch_runs/
# of the checkout, which .gitignore lists);
# DEVICE=cpu runs them on the CPU.
DATASET=${1:-baby}
HERE=$(cd "$(dirname "$0")" && pwd)
ROOT=$(dirname "$HERE")
W=${WORK:-$ROOT/harness_torch_runs}
J=${JOURNAL:-$ROOT/comparison_logs/harness_torch_$DATASET.json}
LOGS=${LOGS:-$W/logs}
N=7
D="--device ${DEVICE:-cuda}"
export OMP_NUM_THREADS=1
mkdir -p "$LOGS"
rm -f "$J"
t0=$(date +%s)
stamp() { echo "$1 rc $2 at $(( $(date +%s) - t0 )) s"; }
for a in baseline user_only cosine_only both; do
  (python "$HERE/run_ablation_prior_torch.py" --dataset "$DATASET" --only $a $D --concurrent $N --workdir "$W/abl_$a" \
     --journal "$J" > "$LOGS/ablation_$a.log" 2>&1; stamp "ablation $a" $?) &
done
(bash "$HERE/run_rf_comparison_torch.sh" "$DATASET" RFBM3 --epochs 50 $D --concurrent $N --workdir "$W/rf" --journal "$J" \
   > "$LOGS/rf_comparison.log" 2>&1; stamp "rf comparison" $?
 python "$HERE/visualize_landscape_torch.py" --model RFBM3 --dataset "$DATASET" --checkpoint "$W/rf/saved/RFBM3-$DATASET" \
   --steps 40 --distance 10 $D --against-plain --journal "$J" --out "$W/landscape_RFBM3_$DATASET.npz" \
   --config-json '{"use_rf": false, "n_layers": 1, "dropout": 0.3, "reg_weight": 0.1, "cl_weight": 2.0}' \
   > "$LOGS/landscape_RFBM3.log" 2>&1; stamp "landscape RFBM3" $?) &
(bash "$HERE/run_comparison_torch.sh" "$DATASET" $D --concurrent $N --workdir "$W/cmp" --journal "$J" \
   > "$LOGS/comparison.log" 2>&1; stamp "comparison" $?
 python "$HERE/visualize_landscape_torch.py" --model DiffMM --dataset "$DATASET" --checkpoint "$W/cmp/saved/DiffMM-$DATASET" \
   --steps 40 --distance 10 $D --against-plain --journal "$J" --out "$W/landscape_DiffMM_$DATASET.npz" \
   > "$LOGS/landscape_DiffMM.log" 2>&1; stamp "landscape DiffMM" $?) &
(python "$HERE/run_rf_staged_search_torch.py" --dataset "$DATASET" --models RFGUME --epochs 5 $D --concurrent $N \
   --workdir "$W/stage" --journal "$J" > "$LOGS/staged_search.log" 2>&1; stamp "staged search" $?) &
wait
echo "all done at $(( $(date +%s) - t0 )) s"
python "$HERE/harness_report_torch.py" "$DATASET" --journal "$J"
