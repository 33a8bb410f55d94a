#!/usr/bin/env bash
# The full VOC 2007 chain with the PyTorch port's tools on the card
# (experiments/scripts/voc_az_frcnn.sh with tools_torch/ in place of tools/).
# Needs data/VOCdevkit2007; it has not run in this repository, which holds no
# VOC data.
set -euo pipefail
cd "$(dirname "$0")/../.."
mkdir -p experiments/logs
LOG="experiments/logs/voc_torch_$(date +%Y%m%d_%H%M%S).log"
exec &> >(tee "$LOG")
CFG=experiments/cfgs/az_vgg16_voc.yml
OUT=${1:-output/voc2007_torch}

python tools_torch/train_net.py --net az --imdb voc_2007_trainval --cfg $CFG --output "$OUT/az"
python tools_torch/propose_net.py --imdb voc_2007_trainval --cfg $CFG --ckpt "$OUT/az" \
    --out "$OUT/proposals_trainval.pkl"
python tools_torch/train_net.py --net frcnn --imdb voc_2007_trainval --cfg $CFG \
    --output "$OUT/frcnn" --proposals "$OUT/proposals_trainval.pkl"
python tools_torch/test_net.py --mode recall --imdb voc_2007_test --cfg $CFG --ckpt "$OUT/az"
python tools_torch/test_net.py --mode detect --imdb voc_2007_test --cfg $CFG \
    --ckpt "$OUT/az" --frcnn-ckpt "$OUT/frcnn" --output "$OUT/eval"
