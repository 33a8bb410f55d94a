#!/usr/bin/env bash
# End-to-end chain on the synthetic dataset with the PyTorch port's tools,
# on the CPU (train AZ -> cache proposals -> train FRCNN -> recall -> mAP);
# experiments/scripts/synthetic_end_to_end.sh with tools_torch/ in place of
# tools/.
# Usage: ./experiments/scripts/synthetic_end_to_end_torch.sh [ITERS] [OUT]
set -euo pipefail
cd "$(dirname "$0")/../.."
mkdir -p experiments/logs
LOG="experiments/logs/synthetic_torch_$(date +%Y%m%d_%H%M%S).log"
exec &> >(tee "$LOG")
CFG=experiments/cfgs/az_smallnet_synthetic.yml
ITERS=${1:-300}
OUT=${2:-output/synthetic_torch}

python tools_torch/train_net.py --cpu --net az --imdb synthetic_train --cfg $CFG \
    --iters "$ITERS" --output "$OUT/az"
python tools_torch/propose_net.py --cpu --imdb synthetic_train --cfg $CFG \
    --ckpt "$OUT/az" --out "$OUT/proposals_train.pkl"
python tools_torch/train_net.py --cpu --net frcnn --imdb synthetic_train --cfg $CFG \
    --iters "$ITERS" --output "$OUT/frcnn" --proposals "$OUT/proposals_train.pkl"
python tools_torch/test_net.py --cpu --mode recall --imdb synthetic_test --cfg $CFG \
    --ckpt "$OUT/az"
python tools_torch/test_net.py --cpu --mode detect --imdb synthetic_test --cfg $CFG \
    --ckpt "$OUT/az" --frcnn-ckpt "$OUT/frcnn" --output "$OUT/eval"
