"""Host NumPy oracle of the zoom search (``aznet_tpu/search/oracle.py``).

The reference's host-driven recursion in plain NumPy: a Python loop over
levels, unpadded frontiers, greedy host NMS. With the caps set it gives the
same proposals as :func:`aznet_tpu_torch.search.propose.az_search`; with
``capped=False`` it is the uncapped recursion. ``_apply_normalized_np`` is
also the labels' template decode (``train/labels.py``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from aznet_tpu_torch.config import SearchConfig
from aznet_tpu_torch.ops.nms import nms as greedy_nms
from aznet_tpu_torch.search.templates import (NUM_DIVISIONS, adjacency_templates_np,
                                              division_table)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _apply_normalized_np(regions, table, offset):
    """Normalized boxes ``table [K, 4]`` in each region's frame -> float32
    ``[R, K, 4]`` image boxes."""
    w = regions[:, 2] - regions[:, 0] + offset
    h = regions[:, 3] - regions[:, 1] + offset
    out = np.empty((regions.shape[0], table.shape[0], 4), np.float32)
    out[..., 0] = regions[:, 0:1] + table[None, :, 0] * w[:, None]
    out[..., 1] = regions[:, 1:2] + table[None, :, 1] * h[:, None]
    out[..., 2] = regions[:, 0:1] + table[None, :, 2] * w[:, None] - offset
    out[..., 3] = regions[:, 1:2] + table[None, :, 3] * h[:, None] - offset
    return out


def _decode_np(anchors, deltas, offset, clip):
    w = anchors[..., 2] - anchors[..., 0] + offset
    h = anchors[..., 3] - anchors[..., 1] + offset
    cx = anchors[..., 0] + 0.5 * w
    cy = anchors[..., 1] + 0.5 * h
    dx, dy, dw, dh = deltas[..., 0], deltas[..., 1], deltas[..., 2], deltas[..., 3]
    if clip is not None:
        dw = np.clip(dw, -clip, clip)
        dh = np.clip(dh, -clip, clip)
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = np.exp(dw) * w
    ph = np.exp(dh) * h
    return np.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], axis=-1)


def az_search_oracle(roi_forward: Callable, feat, im_hw, scfg: SearchConfig,
                     num_templates: int = 11, offset: float = 1.0, capped: bool = True):
    """NumPy zoom search. ``roi_forward(feat, rois [R, 4]) -> dict of logits``
    (NumPy or anything ``np.asarray`` reads). Returns ``(boxes [M, 4], scores
    [M])`` by descending score, M <= NUM_PROPOSALS; ``capped=False`` drops
    the frontier and candidate caps."""
    templates = adjacency_templates_np(num_templates)
    im_h, im_w = float(im_hw[0]), float(im_hw[1])
    r_cap = scfg.FRONTIER_CAP if capped else None
    b_cap = scfg.CAND_BUF if capped else None

    div_table = division_table(scfg.DIV_OVERLAP)
    whole = np.array([[0.0, 0.0, im_w - offset, im_h - offset]], np.float32)
    frontier = [whole]
    current = whole
    for _ in range(scfg.SEED_LEVELS):
        current = _apply_normalized_np(current, div_table, offset).reshape(-1, 4)
        frontier.append(current)
    frontier = np.concatenate(frontier, axis=0)

    cand_boxes = np.zeros((0, 4), np.float32)
    cand_scores = np.zeros((0,), np.float32)
    for _ in range(scfg.MAX_LEVELS):
        if frontier.shape[0] == 0:
            break
        out = roi_forward(feat, frontier)
        zoom_p = _sigmoid(np.asarray(out["zoom"], np.float64))
        adj_p = _sigmoid(np.asarray(out["adj_score"], np.float64)).astype(np.float32)
        deltas = np.asarray(out["adj_delta"], np.float32)

        anchors = _apply_normalized_np(frontier, templates, offset)
        boxes = _decode_np(anchors, deltas, offset, scfg.BBOX_XFORM_CLIP)
        boxes[..., 0::2] = np.clip(boxes[..., 0::2], 0, im_w - offset)
        boxes[..., 1::2] = np.clip(boxes[..., 1::2], 0, im_h - offset)
        cand_boxes = np.concatenate([cand_boxes, boxes.reshape(-1, 4)])
        cand_scores = np.concatenate([cand_scores, adj_p.reshape(-1)])

        children = _apply_normalized_np(frontier, div_table, offset)  # [R, 5, 4]
        cw = children[..., 2] - children[..., 0] + offset
        chh = children[..., 3] - children[..., 1] + offset
        parent_ok = zoom_p > scfg.ZOOM_THRESH
        child_ok = parent_ok[:, None] & (np.minimum(cw, chh) >= scfg.MIN_SIZE)
        priority = np.where(child_ok, zoom_p[:, None].repeat(NUM_DIVISIONS, 1), -np.inf)
        flat_children = children.reshape(-1, 4)
        flat_priority = priority.reshape(-1)
        order = np.argsort(-flat_priority, kind="stable")
        if r_cap is not None:
            order = order[:r_cap]
        order = order[np.isfinite(flat_priority[order])]
        frontier = flat_children[order]

    # One cap at the end (the device's one top-K before NMS).
    if b_cap is not None and cand_scores.shape[0] > b_cap:
        keep = np.argsort(-cand_scores, kind="stable")[:b_cap]
        cand_boxes, cand_scores = cand_boxes[keep], cand_scores[keep]

    m = cand_scores >= scfg.CONF_THRESH
    cand_boxes, cand_scores = cand_boxes[m], cand_scores[m]
    if cand_boxes.shape[0] == 0:
        return cand_boxes, cand_scores
    order = np.argsort(-cand_scores, kind="stable")
    cand_boxes, cand_scores = cand_boxes[order], cand_scores[order]
    dets = np.concatenate([cand_boxes, cand_scores[:, None]], axis=1)
    keep = greedy_nms(dets, scfg.NMS_THRESH, offset=offset)[: scfg.NUM_PROPOSALS]
    return cand_boxes[keep], cand_scores[keep]
