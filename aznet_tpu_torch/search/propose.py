"""Adjacency-and-zoom search over one image's features
(``aznet_tpu/search/propose.py::az_search``).

Per level: the head on the padded frontier, decode K adjacency candidates
per region, divide the regions whose zoom score passes into 5 children, and
keep the top ``next_cap`` children by parent zoom. The early levels, whose
lossless capacity is below FRONTIER_CAP, are unrolled with their own
shapes; the steady-state tail is a Python loop that stops when no frontier
row is valid. The candidates are capped at CAND_BUF by score and go through
exact greedy NMS to the top NUM_PROPOSALS.

Two sentinels, as in the reference: the search pads scores with the finite
``NEG_INF = -1e30`` (no inf - inf hazards), while NMS masks with -inf.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from aznet_tpu.config import SearchConfig
from aznet_tpu_torch.ops.boxes import bbox_transform_inv, clip_boxes
from aznet_tpu_torch.ops.nms import nms_topk
from aznet_tpu_torch.ops.topk import top_k
from aznet_tpu_torch.search.templates import (
    NUM_DIVISIONS,
    _apply_normalized,
    adjacency_templates,
    division_table,
    divide_regions,
    template_boxes,
)

NEG_INF = -1e30


def seed_count(seed_levels: int) -> int:
    """Number of initial frontier regions: 1 + 5 + 25 + ..."""
    return sum(NUM_DIVISIONS ** lvl for lvl in range(seed_levels + 1))


def frontier_schedule(scfg: SearchConfig) -> Tuple[int, ...]:
    """Lossless per-level frontier capacities, multiples of 8 capped at
    FRONTIER_CAP (level i holds at most seed_count * 5**i regions)."""
    n = seed_count(scfg.SEED_LEVELS)
    caps = []
    for _ in range(scfg.MAX_LEVELS):
        caps.append(min(scfg.FRONTIER_CAP, max(8, -(-n // 8) * 8)))
        n *= NUM_DIVISIONS
    return tuple(caps)


def init_frontier(im_h, im_w, scfg: SearchConfig, offset: float = 1.0,
                  cap: int | None = None):
    """The whole image plus SEED_LEVELS of its divisions, padded to ``cap``
    (default FRONTIER_CAP). ``im_h``/``im_w`` may be 0-d tensors, whose
    device the result takes. Returns ``(boxes [R, 4], valid [R])``."""
    r = scfg.FRONTIER_CAP if cap is None else cap
    device = next((v.device for v in (im_h, im_w) if isinstance(v, torch.Tensor)), None)
    im_h = torch.as_tensor(im_h, dtype=torch.float32, device=device)
    im_w = torch.as_tensor(im_w, dtype=torch.float32, device=device)
    zero = torch.zeros_like(im_w)
    current = torch.stack([zero, zero, im_w - offset, im_h - offset])[None]
    seeds = [current]
    for _ in range(scfg.SEED_LEVELS):
        current = divide_regions(current, scfg.DIV_OVERLAP, offset).reshape(-1, 4)
        seeds.append(current)
    boxes = torch.cat(seeds)
    n = boxes.shape[0]
    if n > r:
        raise ValueError(f"SEED_LEVELS={scfg.SEED_LEVELS} yields {n} seed regions "
                         f"> FRONTIER_CAP={r}")
    boxes = torch.nn.functional.pad(boxes, (0, 0, 0, r - n))
    return boxes, torch.arange(r, device=device) < n


def az_search(roi_forward: Callable, feat: torch.Tensor, im_hw, scfg: SearchConfig,
              num_templates: int = 11, offset: float = 1.0,
              collect_frontier: bool = False):
    """Zoom search over ``feat [h, w, C]`` of one image whose valid scaled
    extents are ``im_hw``. ``roi_forward(feat, rois [R, 4])`` returns the
    head's logits dict. Returns ``(boxes [N, 4], scores [N], valid [N])``,
    N = NUM_PROPOSALS, in the scaled image's coordinates."""
    if collect_frontier:
        raise NotImplementedError("collect_frontier (hard-region mining) is not ported")
    dev = feat.device
    r_cap = scfg.FRONTIER_CAP
    templates = adjacency_templates(num_templates, device=dev)
    divisions = torch.as_tensor(division_table(scfg.DIV_OVERLAP), device=dev)
    im_h = torch.as_tensor(im_hw[0], dtype=torch.float32, device=dev)
    im_w = torch.as_tensor(im_hw[1], dtype=torch.float32, device=dev)
    sched = frontier_schedule(scfg)

    def level_step(f_boxes, f_valid, next_cap):
        out = roi_forward(feat, f_boxes)
        zoom_p = torch.sigmoid(out["zoom"])
        adj_p = torch.sigmoid(out["adj_score"])
        anchors = template_boxes(f_boxes, templates, offset)
        boxes = bbox_transform_inv(anchors, out["adj_delta"], offset, clip=scfg.BBOX_XFORM_CLIP)
        boxes = clip_boxes(boxes, (im_h, im_w), offset)
        scores = torch.where(f_valid[:, None], adj_p, NEG_INF)

        children = _apply_normalized(f_boxes, divisions, offset)  # [R, 5, 4]
        cw = children[..., 2] - children[..., 0] + offset
        ch = children[..., 3] - children[..., 1] + offset
        parent_ok = f_valid & (zoom_p > scfg.ZOOM_THRESH)
        child_ok = parent_ok[:, None] & (torch.minimum(cw, ch) >= scfg.MIN_SIZE)
        priority = torch.where(child_ok, zoom_p[:, None], NEG_INF).reshape(-1)
        cboxes = children.reshape(-1, 4)
        if next_cap > priority.shape[0]:  # the schedule grows at most 5x
            pad = next_cap - priority.shape[0]
            priority = torch.nn.functional.pad(priority, (0, pad), value=NEG_INF)
            cboxes = torch.nn.functional.pad(cboxes, (0, 0, 0, pad))
        # Ties are certain here (a parent's five children share its zoom
        # score); top_k keeps the lower index first, as jax.lax.top_k.
        top_p, top_i = top_k(priority, next_cap)
        return boxes.reshape(-1, 4), scores.reshape(-1), cboxes[top_i], top_p > NEG_INF

    f_boxes, f_valid = init_frontier(im_h, im_w, scfg, offset, cap=sched[0])
    cand_b, cand_s = [], []
    lvl = 0
    while lvl < scfg.MAX_LEVELS and sched[lvl] != r_cap:
        next_cap = sched[lvl + 1] if lvl + 1 < scfg.MAX_LEVELS else sched[lvl]
        b, s, f_boxes, f_valid = level_step(f_boxes, f_valid, next_cap)
        cand_b.append(b)
        cand_s.append(s)
        lvl += 1

    # Steady-state tail: one slot per (level, region, template), filled until
    # the frontier empties; unfilled levels stay at NEG_INF.
    rem = scfg.MAX_LEVELS - lvl
    if rem > 0:
        per_level = r_cap * num_templates
        tail_b = torch.zeros((rem * per_level, 4), dtype=torch.float32, device=dev)
        tail_s = torch.full((rem * per_level,), NEG_INF, dtype=torch.float32, device=dev)
        for level in range(rem):
            if not bool(f_valid.any()):
                break
            b, s, f_boxes, f_valid = level_step(f_boxes, f_valid, r_cap)
            tail_b[level * per_level:(level + 1) * per_level] = b
            tail_s[level * per_level:(level + 1) * per_level] = s
        cand_b.append(tail_b)
        cand_s.append(tail_s)

    c_boxes = torch.cat(cand_b)
    c_scores = torch.cat(cand_s)
    if c_scores.shape[0] > scfg.CAND_BUF:  # the one lossy step: cap by score
        c_scores, idx = top_k(c_scores, scfg.CAND_BUF)
        c_boxes = c_boxes[idx]

    final_scores = torch.where(c_scores >= scfg.CONF_THRESH, c_scores, NEG_INF)
    live = final_scores > NEG_INF
    return nms_topk(c_boxes, final_scores, scfg.NMS_THRESH, scfg.NUM_PROPOSALS,
                    valid=live, offset=offset)
