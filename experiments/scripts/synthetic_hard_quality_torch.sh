#!/usr/bin/env bash
# The hard synthetic quality chain with the PyTorch port's tools on the card
# (experiments/scripts/synthetic_hard_quality.sh with tools_torch/ in place of
# tools/): train AZ -> cache proposals -> train FRCNN -> recall (one-shot,
# +refine) -> mAP (one-shot, BBOX_ITER 2), plus two legs the reference chain
# does not have: int8 recall (the int8 conv kernel's chain and strip entries
# on trained weights) and detect with 'align_pallas' + FUSE_CONV1 (the
# ROI-align and fused conv1 kernels). Each leg prints its wall time.
# The default config is full-width VGG-16, the configuration of the
# reference's recorded quality figures (DESIGN.md, round 4).
# Usage: ./experiments/scripts/synthetic_hard_quality_torch.sh [AZ_ITERS] [FRCNN_ITERS] [OUT]
# A rerun with the same OUT resumes each training run from its latest snapshot.
set -euo pipefail
cd "$(dirname "$0")/../.."
mkdir -p experiments/logs
LOG="experiments/logs/synthetic_hard_torch_$(date +%Y%m%d_%H%M%S).log"
exec &> >(tee "$LOG")
CFG=${CFG:-experiments/cfgs/az_vgg_w100_synthetic_hard.yml}
AZ_ITERS=${1:-8000}
FRCNN_ITERS=${2:-6000}
OUT=${3:-output/quality_torch}

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader || true
leg() {  # leg NAME COMMAND...: run COMMAND, then print its wall time
    local name=$1 t0
    shift
    echo "== $name =="
    t0=$(date +%s.%N)
    "$@"
    echo "[leg] $name: $(awk -v a="$t0" -v b="$(date +%s.%N)" 'BEGIN { printf "%.1f", b - a }') s"
}

leg "train az" python tools_torch/train_net.py --net az --imdb synthetic_hard_train \
    --cfg $CFG --iters "$AZ_ITERS" --output "$OUT/az"
leg "propose train" python tools_torch/propose_net.py --imdb synthetic_hard_train \
    --cfg $CFG --ckpt "$OUT/az" --batched --out "$OUT/proposals_train.pkl"
# SHARED=1 trains the FRCNN head against the frozen AZ trunk, as in the
# reference script.
leg "train frcnn" python tools_torch/train_net.py --net frcnn --imdb synthetic_hard_train \
    --cfg $CFG --iters "$FRCNN_ITERS" --output "$OUT/frcnn" \
    --proposals "$OUT/proposals_train.pkl" ${SHARED:+--init-trunk-from "$OUT/az"}
leg "recall (one-shot)" python tools_torch/test_net.py --mode recall \
    --imdb synthetic_hard_test --cfg $CFG --ckpt "$OUT/az" --batched
leg "recall (+refine second decode pass)" python tools_torch/test_net.py --mode recall \
    --imdb synthetic_hard_test --cfg $CFG --ckpt "$OUT/az" --batched --refine \
    --frcnn-ckpt "$OUT/frcnn"
leg "detect (one-shot)" python tools_torch/test_net.py --mode detect \
    --imdb synthetic_hard_test --cfg $CFG --ckpt "$OUT/az" --frcnn-ckpt "$OUT/frcnn" \
    --output "$OUT/eval"
leg "detect (BBOX_ITER=2 iterative decode)" python tools_torch/test_net.py --mode detect \
    --imdb synthetic_hard_test --cfg $CFG --ckpt "$OUT/az" --frcnn-ckpt "$OUT/frcnn" \
    --output "$OUT/eval_iter2" --set TEST.BBOX_ITER 2
leg "recall (int8)" python tools_torch/test_net.py --mode recall \
    --imdb synthetic_hard_test --cfg $CFG --ckpt "$OUT/az" --batched --int8
leg "detect (align_pallas + FUSE_CONV1)" python tools_torch/test_net.py --mode detect \
    --imdb synthetic_hard_test --cfg $CFG --ckpt "$OUT/az" --frcnn-ckpt "$OUT/frcnn" \
    --output "$OUT/eval_fused_kernels" --set MODEL.POOLING_MODE align_pallas \
    MODEL.FUSE_CONV1 True
