"""Inputs for one search level after the head, shared by the CPU tests
(``tests/test_torch_search.py``, against the JAX package) and the card tests
(``tests/test_torch_search_level.py``, the kernel against the plain
``level_step``). Imports no JAX.

A level's inputs are the head's logits as ``AZHead`` hands them out (strided
views of one ``[R, 1 + 5K]`` output, as ``fused_heads`` makes it), the
frontier and the search's constants. ``stand_in_head`` is a head for whole
searches: a function of the rois alone, so that every region of a large
image divides while the zoom scores keep a real order.
"""

from __future__ import annotations

import numpy as np
import torch

from aznet_tpu_torch.config import SearchConfig
from aznet_tpu_torch.search import propose

# The SEAR settings of the benchmark's two configurations
# (benchmark/configs/vgg16.json, resnet50_1080p.json) and an image of each.
SEARCH_CONFIGS = {
    "vgg16": (SearchConfig(ZOOM_THRESH=0.2, CONF_THRESH=0.05, MAX_LEVELS=6, MIN_SIZE=16.0,
                           FRONTIER_CAP=64, CAND_BUF=2048, NUM_PROPOSALS=300, NMS_THRESH=0.7,
                           DIV_OVERLAP=0.0, SEED_LEVELS=1),
              (600, 800)),
    "resnet50_1080p": (SearchConfig(ZOOM_THRESH=0.2, CONF_THRESH=0.05, MAX_LEVELS=7,
                                    MIN_SIZE=16.0, FRONTIER_CAP=128, CAND_BUF=4096,
                                    NUM_PROPOSALS=1000, NMS_THRESH=0.7, DIV_OVERLAP=0.0,
                                    SEED_LEVELS=1),
                       (1080, 1920)),
}
K = 11
CASES = ("random", "pad", "all_invalid", "below_min_size", "beyond_clip", "zero_logits",
         "cross_parent_ties")


def schedule_steps(scfg: SearchConfig):
    """``(R, next_cap)`` of each level the search can run."""
    sched = propose.frontier_schedule(scfg)
    return [(cap, sched[i + 1] if i + 1 < len(sched) else cap) for i, cap in enumerate(sched)]


def head_outputs(y: torch.Tensor, k: int) -> dict:
    """``AZHead``'s split of its fused output ``y [R, 1 + 5K]``."""
    return {"zoom": y[:, 0:1][:, 0], "adj_score": y[:, 1:1 + k],
            "adj_delta": y[:, 1 + k:].reshape(-1, k, 4)}


def level_case(case: str, r: int, seed: int, device, k: int = K, im_hw=(600, 800),
               scfg: SearchConfig = SEARCH_CONFIGS["vgg16"][0]):
    """``(out, f_boxes, f_valid, next_cap, consts)`` of one level: a frontier
    of ``r`` regions, most valid, inside the image, and the head's logits.
    ``case`` picks what is extreme: ``pad`` a next_cap of 8R (> 5R);
    ``all_invalid`` no valid region; ``below_min_size`` regions whose
    children are mostly under MIN_SIZE; ``beyond_clip`` dw/dh far beyond
    BBOX_XFORM_CLIP and centres off the image; ``zero_logits`` every logit
    +0 or -0; ``cross_parent_ties`` one zoom logit for every region."""
    rng = np.random.RandomState(seed)
    h, w = im_hw
    side = rng.uniform(4.0, 40.0, (r, 2)) if case == "below_min_size" else \
        np.exp(rng.uniform(np.log(8.0), np.log(min(h, w)), (r, 2)))
    x1 = rng.uniform(0, w - side[:, 0])
    y1 = rng.uniform(0, h - side[:, 1])
    boxes = np.stack([x1, y1, x1 + side[:, 0] - 1, y1 + side[:, 1] - 1], 1).astype(np.float32)
    valid = rng.rand(r) < 0.85
    if case == "all_invalid":
        valid[:] = False
    y = rng.normal(0.0, 1.0, (r, 1 + 5 * k)).astype(np.float32)
    y[:, 0] = rng.normal(1.0, 1.5, r)  # zoom logits, about a quarter under ZOOM_THRESH
    y[:, 1 + k:] *= 0.3
    if case == "beyond_clip":
        y[:, 1 + k:] *= 20.0
    elif case == "zero_logits":
        y[:] = np.where(rng.rand(*y.shape) < 0.5, np.float32(0.0), np.float32(-0.0))
    elif case == "cross_parent_ties":
        y[:, 0] = 0.75
    next_cap = 8 * r if case == "pad" else r
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    consts = propose.level_consts(scfg, k, torch.tensor([float(h), float(w)], device=device))
    return head_outputs(t(y), k), t(boxes), t(valid), next_cap, consts


def stand_in_head(k: int = K):
    """``roi_forward(feat, rois)`` for whole searches: logits from each
    roi's size and position in float32, returned as ``AZHead`` splits its
    fused output. The zoom logit grows with the region's area, so a region
    ranks above its children's generation, and varies with its position, so
    parents rarely tie."""
    cols = torch.arange(1 + 5 * k, dtype=torch.float32)

    def roi_forward(feat, rois):
        c = cols.to(rois.device)
        w = rois[:, 2] - rois[:, 0] + 1.0
        h = rois[:, 3] - rois[:, 1] + 1.0
        phase = 0.013 * rois[:, 0] + 0.029 * rois[:, 1] + 0.007 * w
        y = 0.6 * torch.sin(phase[:, None] * (1.0 + 0.37 * c) + c)
        zoom = 0.25 * torch.log(w * h) - 1.0 + 0.8 * torch.sin(phase)
        return head_outputs(torch.cat([zoom[:, None], y[:, 1:1 + k], 0.5 * y[:, 1 + k:]], 1), k)

    return roi_forward
