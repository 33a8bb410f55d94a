"""Proposal recall@K over IoU thresholds.

Counterpart of ``aznet_tpu/eval/recall.py``: per image, IoU(gt,
proposals) with the top-K proposals (host NumPy, ``utils/np_boxes.py``);
recall = the fraction of gt boxes matched above the threshold.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from aznet_tpu_torch.utils.np_boxes import iou_np as _iou_np


def proposal_recall(
    gt_boxes: List[np.ndarray],
    proposals: List[np.ndarray],
    top_k: int = 300,
    iou_thresh: float = 0.5,
    offset: float = 1.0,
) -> float:
    """Recall of gt over the top-K proposals per image.

    ``proposals[i]``: [N, 4+] score-sorted boxes for image i.
    """
    matched = 0
    total = 0
    for gt, props in zip(gt_boxes, proposals):
        total += gt.shape[0]
        if gt.shape[0] == 0 or props.shape[0] == 0:
            continue
        iou = _iou_np(gt, props[:top_k, :4], offset)
        matched += int((iou.max(axis=1) >= iou_thresh).sum())
    return matched / max(total, 1)


def recall_table(
    gt_boxes: List[np.ndarray],
    proposals: List[np.ndarray],
    top_ks: Sequence[int] = (100, 300, 1000),
    iou_threshs: Sequence[float] = (0.5, 0.6, 0.7, 0.8, 0.9),
    offset: float = 1.0,
) -> Dict[int, Dict[float, float]]:
    """The reference's recall grid: {K: {IoU: recall}} + average recall."""
    out: Dict[int, Dict[float, float]] = {}
    for k in top_ks:
        out[k] = {}
        for t in iou_threshs:
            out[k][t] = proposal_recall(gt_boxes, proposals, k, t, offset)
        out[k]["AR"] = float(np.mean([out[k][t] for t in iou_threshs]))
    return out
