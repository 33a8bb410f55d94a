#!/usr/bin/env bash
# Recall-coverage sweep with the PyTorch port's tools on the card
# (experiments/scripts/recall_coverage_sweep.sh with tools_torch/ in place of
# tools/, without its pauses between runs): eval-time SEAR settings that grow
# the candidate pool itself (finer zoom, overlapping divisions, a wider
# frontier, more seed levels), each a batched recall run on one AZ snapshot.
# Usage: ./experiments/scripts/recall_coverage_sweep_torch.sh [CKPT] [IMDB]
set -uo pipefail
cd "$(dirname "$0")/../.."
mkdir -p experiments/logs
LOG="experiments/logs/recall_sweep_torch_$(date +%Y%m%d_%H%M%S).log"
exec &> >(tee "$LOG")
CFG=${CFG:-experiments/cfgs/az_vgg_w100_synthetic_hard.yml}
CKPT=${1:-output/quality_torch/az}
IMDB=${2:-synthetic_hard_test}

run() {
  local name="$1"; shift
  echo "=== sweep: $name  ($*)"
  if [ "$#" -gt 0 ]; then
    python tools_torch/test_net.py --mode recall --imdb "$IMDB" --cfg "$CFG" \
        --ckpt "$CKPT" --batched --set "$@"
  else
    python tools_torch/test_net.py --mode recall --imdb "$IMDB" --cfg "$CFG" \
        --ckpt "$CKPT" --batched
  fi
}

run baseline
run zoom_0.10      SEAR.ZOOM_THRESH 0.10
run zoom_0.05      SEAR.ZOOM_THRESH 0.05
run div_overlap    SEAR.DIV_OVERLAP 0.25
run frontier_128   SEAR.FRONTIER_CAP 128
run seed_2         SEAR.SEED_LEVELS 2
run combo          SEAR.ZOOM_THRESH 0.05 SEAR.DIV_OVERLAP 0.25 SEAR.FRONTIER_CAP 128
