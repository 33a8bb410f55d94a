"""AZ training labels on the host, NumPy (``aznet_tpu/train/labels.py``).

- **Zoom label** of a region: 1 iff it contains a gt box (inter / gt area >=
  ``ZOOM_CONTAIN_THRESH``) that is small beside it (gt area / region area <
  ``ZOOM_AREA_FRAC``).
- **Adjacency labels**: each of the K template anchors of a region matches
  the gt box of highest IoU; its confidence label is 1 iff that IoU >=
  ``ADJ_FG_THRESH``, with a regression target toward the box, normalized by
  ``BBOX_NORMALIZE_MEANS`` / ``STDS``.

Regions: the division tree down to a few levels plus jittered gt boxes (and
mined search regions), subsampled with a bias toward regions near a gt box.
"""

from __future__ import annotations

import numpy as np

from aznet_tpu_torch.config import TrainConfig
from aznet_tpu_torch.search.oracle import _apply_normalized_np
from aznet_tpu_torch.search.templates import adjacency_templates_np, division_table
from aznet_tpu_torch.utils.np_boxes import (area_np as _area, bbox_transform_np as _bbox_transform_np,
                                            intersection_np as _inter, iou_np as _iou)


def division_tree_regions(im_hw, levels: int, min_size: float = 0.0, offset: float = 1.0,
                          div_overlap: float = 0.0) -> np.ndarray:
    """All regions of the division tree down to ``levels``; with ``min_size``
    a level keeps only regions whose shorter side is at least that.
    ``div_overlap`` must be the search's ``SEAR.DIV_OVERLAP``."""
    table = division_table(div_overlap)
    h, w = float(im_hw[0]), float(im_hw[1])
    whole = np.array([[0.0, 0.0, w - offset, h - offset]], np.float32)
    out = [whole]
    current = whole
    for _ in range(levels):
        current = _apply_normalized_np(current, table, offset).reshape(-1, 4)
        if min_size:
            sz = np.minimum(current[:, 2] - current[:, 0] + offset,
                            current[:, 3] - current[:, 1] + offset)
            current = current[sz >= min_size]
        if current.size == 0:
            break
        out.append(current)
    return np.concatenate(out, axis=0)


def perturb_gt_regions(gt: np.ndarray, im_hw, n_per_gt: int, rng,
                       offset: float = 1.0) -> np.ndarray:
    """``n_per_gt`` copies of each gt box, scaled by ``exp(U(-0.4, 0.6))``
    and shifted by ``U(-0.2, 0.2)`` of its size per axis, clipped."""
    if gt.shape[0] == 0 or n_per_gt == 0:
        return np.zeros((0, 4), np.float32)
    h, w = float(im_hw[0]), float(im_hw[1])
    reps = np.repeat(gt, n_per_gt, axis=0).astype(np.float32)
    gw = reps[:, 2] - reps[:, 0] + offset
    gh = reps[:, 3] - reps[:, 1] + offset
    scale = np.exp(rng.uniform(-0.4, 0.6, (reps.shape[0], 2)))
    shift = rng.uniform(-0.2, 0.2, (reps.shape[0], 2))
    cx = reps[:, 0] + 0.5 * gw + shift[:, 0] * gw
    cy = reps[:, 1] + 0.5 * gh + shift[:, 1] * gh
    nw = gw * scale[:, 0]
    nh = gh * scale[:, 1]
    out = np.stack([cx - 0.5 * nw, cy - 0.5 * nh, cx + 0.5 * nw - offset, cy + 0.5 * nh - offset],
                   axis=1)
    out[:, 0::2] = np.clip(out[:, 0::2], 0, w - offset)
    out[:, 1::2] = np.clip(out[:, 1::2], 0, h - offset)
    return out.astype(np.float32)


def az_labels_for_regions(regions: np.ndarray, gt: np.ndarray, tcfg: TrainConfig,
                          templates: np.ndarray, offset: float = 1.0):
    """Labels of ``regions [R, 4]`` against ``gt [G, 4]``: ``zoom_labels
    [R]``, ``adj_labels [R, K]``, ``adj_targets [R, K, 4]`` (normalized) and
    ``adj_inside [R, K, 4]``, float32."""
    r, k = regions.shape[0], templates.shape[0]
    out = {
        "zoom_labels": np.zeros((r,), np.float32),
        "adj_labels": np.zeros((r, k), np.float32),
        "adj_targets": np.zeros((r, k, 4), np.float32),
        "adj_inside": np.zeros((r, k, 4), np.float32),
    }
    if gt.shape[0] == 0 or r == 0:
        return out

    inter = _inter(gt, regions, offset)  # [G, R]
    contained = inter / _area(gt, offset)[:, None] >= tcfg.ZOOM_CONTAIN_THRESH
    small = _area(gt, offset)[:, None] / _area(regions, offset)[None] < tcfg.ZOOM_AREA_FRAC
    out["zoom_labels"] = np.any(contained & small, axis=0).astype(np.float32)

    flat = _apply_normalized_np(regions, templates, offset).reshape(-1, 4)  # [R*K, 4]
    iou = _iou(flat, gt, offset)  # [R*K, G]
    best = np.argmax(iou, axis=1)
    pos = iou[np.arange(iou.shape[0]), best] >= tcfg.ADJ_FG_THRESH
    targets = _bbox_transform_np(flat, gt[best], offset)
    if tcfg.BBOX_NORMALIZE_TARGETS:
        means = np.asarray(tcfg.BBOX_NORMALIZE_MEANS, np.float32)
        stds = np.asarray(tcfg.BBOX_NORMALIZE_STDS, np.float32)
        targets = (targets - means) / stds
    out["adj_labels"] = pos.reshape(r, k).astype(np.float32)
    out["adj_targets"] = np.where(pos[:, None], targets, 0.0).reshape(r, k, 4)
    out["adj_inside"] = np.repeat(pos[:, None], 4, axis=1).astype(np.float32).reshape(r, k, 4)
    return out


def sample_az_regions(gt: np.ndarray, im_hw, tcfg: TrainConfig, rng, tree_levels: int = 3,
                      n_per_gt: int = 8, offset: float = 1.0, div_overlap: float = 0.0,
                      extra: np.ndarray | None = None) -> np.ndarray:
    """One image's anchor regions: the division tree, jittered gt boxes and
    the ``extra`` (mined) regions, subsampled to ``REGIONS_PER_IMAGE`` with up
    to half of them at IoU >= 0.3 with a gt box."""
    tree = division_tree_regions(im_hw, tree_levels, offset=offset, div_overlap=div_overlap)
    pool = [tree, perturb_gt_regions(gt, im_hw, n_per_gt, rng, offset=offset)]
    if extra is not None and extra.size:
        pool.append(np.asarray(extra, np.float32).reshape(-1, 4))
    regions = np.concatenate(pool, axis=0)
    n = tcfg.REGIONS_PER_IMAGE
    if regions.shape[0] <= n:
        return regions
    ov = _iou(regions, gt, offset).max(axis=1) if gt.shape[0] else np.zeros(regions.shape[0])
    pos_idx = np.flatnonzero(ov >= 0.3)
    neg_idx = np.flatnonzero(ov < 0.3)
    n_pos = min(len(pos_idx), n // 2)
    pick_pos = rng.choice(pos_idx, n_pos, replace=False) if n_pos else np.zeros(0, np.int64)
    n_neg = n - n_pos
    if len(neg_idx) >= n_neg:
        pick_neg = rng.choice(neg_idx, n_neg, replace=False)
    else:
        pick_neg = np.concatenate([neg_idx, rng.choice(regions.shape[0], n_neg - len(neg_idx))])
    return regions[np.concatenate([pick_pos, pick_neg]).astype(np.int64)]


def compute_bbox_target_stats(imdb, cfg, proposals_by_entry=None, max_images: int = 200):
    """Per-coordinate mean and std (+1e-8) of the foreground adjacency
    targets, sampled as training samples them, over the first ``max_images``
    images (the reference's ``add_bbox_regression_targets``); the config's
    stds and zero means when no region is foreground."""
    rng = np.random.RandomState(cfg.RNG_SEED)
    templates = adjacency_templates_np(cfg.MODEL.NUM_TEMPLATES)
    all_targets = []
    for i in range(min(imdb.num_images, max_images)):
        entry = imdb.roidb[i]
        gt = entry["boxes"]
        diff = entry.get("difficult")
        if diff is not None and diff.any():
            gt = gt[~diff]
        if gt.shape[0] == 0:
            continue
        regions = sample_az_regions(gt, (entry["height"], entry["width"]), cfg.TRAIN, rng,
                                    offset=cfg.BOX_OFFSET, div_overlap=cfg.SEAR.DIV_OVERLAP)
        flat = _apply_normalized_np(regions, templates, cfg.BOX_OFFSET).reshape(-1, 4)
        iou = _iou(flat, gt, cfg.BOX_OFFSET)
        best = np.argmax(iou, axis=1)
        pos = iou[np.arange(iou.shape[0]), best] >= cfg.TRAIN.ADJ_FG_THRESH
        if pos.any():
            all_targets.append(_bbox_transform_np(flat[pos], gt[best[pos]], cfg.BOX_OFFSET))
    if not all_targets:
        return np.zeros(4, np.float32), np.asarray(cfg.TRAIN.BBOX_NORMALIZE_STDS, np.float32)
    t = np.concatenate(all_targets)
    return t.mean(axis=0).astype(np.float32), (t.std(axis=0) + 1e-8).astype(np.float32)
