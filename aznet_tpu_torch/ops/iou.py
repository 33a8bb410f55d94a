"""IoU and overlap matrices (counterpart of ``aznet_tpu/ops/iou.py``:
``bbox_overlaps``, ``intersection_over_area``)."""

from __future__ import annotations

import torch


def bbox_overlaps(boxes, query_boxes, offset: float = 1.0):
    """IoU of ``boxes [N, 4]`` against ``query_boxes [K, 4]`` -> ``[N, K]``,
    ``+offset`` areas, 0 where the union is <= 0."""
    b = boxes.float()[..., :, None, :]
    q = query_boxes.float()[..., None, :, :]
    iw = torch.minimum(b[..., 2], q[..., 2]) - torch.maximum(b[..., 0], q[..., 0]) + offset
    ih = torch.minimum(b[..., 3], q[..., 3]) - torch.maximum(b[..., 1], q[..., 1]) + offset
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    area_b = (b[..., 2] - b[..., 0] + offset) * (b[..., 3] - b[..., 1] + offset)
    area_q = (q[..., 2] - q[..., 0] + offset) * (q[..., 3] - q[..., 1] + offset)
    union = area_b + area_q - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def intersection_over_area(boxes, query_boxes, offset: float = 1.0):
    """Intersection of ``boxes [N, 4]`` with ``query_boxes [K, 4]`` over the
    area of ``boxes`` -> ``[N, K]``, ``+offset`` widths, 0 where that area is
    <= 0."""
    b = boxes.float()[..., :, None, :]
    q = query_boxes.float()[..., None, :, :]
    iw = torch.minimum(b[..., 2], q[..., 2]) - torch.maximum(b[..., 0], q[..., 0]) + offset
    ih = torch.minimum(b[..., 3], q[..., 3]) - torch.maximum(b[..., 1], q[..., 1]) + offset
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    area_b = (b[..., 2] - b[..., 0] + offset) * (b[..., 3] - b[..., 1] + offset)
    return torch.where(area_b > 0, inter / area_b, torch.zeros_like(inter))
