#!/usr/bin/env bash
# Alternating training for exact trunk sharing with the PyTorch port's tools
# on the card (experiments/scripts/alternating_shared_trunk.sh with
# tools_torch/ in place of tools/, without its pauses between legs):
#   A. Fast R-CNN warm-started from the AZ trunk, trunk finetuned with it
#   B. AZ heads retrained on the detector's frozen trunk
#   C. recall of the retrained AZ-Net (proposal quality must hold)
#   D. fused shared-trunk detection (real mAP at the fused program's speed)
# Prereqs: a trained AZ snapshot and cached proposals (the first half of
# synthetic_hard_quality_torch.sh).
# Usage: ./experiments/scripts/alternating_shared_trunk_torch.sh [OUT] [AZ_ITERS] [FRCNN_ITERS]
set -euo pipefail
cd "$(dirname "$0")/../.."
mkdir -p experiments/logs
LOG="experiments/logs/alternating_torch_$(date +%Y%m%d_%H%M%S).log"
exec &> >(tee "$LOG")
CFG=${CFG:-experiments/cfgs/az_vgg_w100_synthetic_hard.yml}
OUT=${1:-output/quality_torch}
AZ_ITERS=${2:-8000}
FRCNN_ITERS=${3:-6000}
PROP=${PROP:-$OUT/proposals_train.pkl}

python tools_torch/train_net.py --net frcnn --imdb synthetic_hard_train --cfg $CFG \
    --iters "$FRCNN_ITERS" --output "$OUT/frcnn_alt" \
    --proposals "$PROP" \
    --init-trunk-from "$OUT/az" --trunk-trainable
python tools_torch/train_net.py --net az --imdb synthetic_hard_train --cfg $CFG \
    --iters "$AZ_ITERS" --output "$OUT/az_alt" \
    --init-trunk-from "$OUT/frcnn_alt"
python tools_torch/test_net.py --mode recall --imdb synthetic_hard_test --cfg $CFG \
    --ckpt "$OUT/az_alt" --batched
python tools_torch/test_net.py --mode detect --imdb synthetic_hard_test --cfg $CFG \
    --ckpt "$OUT/az_alt" --frcnn-ckpt "$OUT/frcnn_alt" --share-trunk \
    --batched --output "$OUT/eval_alt"
