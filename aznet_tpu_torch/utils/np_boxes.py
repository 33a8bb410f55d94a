"""Host-side (NumPy) box math with the ``+offset`` conventions.

Counterpart of ``aznet_tpu/utils/np_boxes.py`` (a copy: the port imports
nothing of ``aznet_tpu``). The tensor versions live in ``ops/boxes.py`` and
``ops/iou.py``; these serve evaluation (recall) and, later, label generation.
"""

from __future__ import annotations

import numpy as np


def area_np(boxes: np.ndarray, offset: float = 1.0) -> np.ndarray:
    return (boxes[..., 2] - boxes[..., 0] + offset) * (
        boxes[..., 3] - boxes[..., 1] + offset)


def intersection_np(a: np.ndarray, b: np.ndarray, offset: float = 1.0) -> np.ndarray:
    """Pairwise intersection areas [N, K]."""
    iw = (np.minimum(a[:, None, 2], b[None, :, 2])
          - np.maximum(a[:, None, 0], b[None, :, 0]) + offset)
    ih = (np.minimum(a[:, None, 3], b[None, :, 3])
          - np.maximum(a[:, None, 1], b[None, :, 1]) + offset)
    return np.maximum(iw, 0) * np.maximum(ih, 0)


def iou_np(a: np.ndarray, b: np.ndarray, offset: float = 1.0) -> np.ndarray:
    """IoU matrix [N, K] (cython_bbox semantics)."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    inter = intersection_np(a, b, offset)
    union = area_np(a, offset)[:, None] + area_np(b, offset)[None] - inter
    return np.where(union > 0, inter / union, 0.0).astype(np.float32)


def bbox_transform_np(ex: np.ndarray, gt: np.ndarray, offset: float = 1.0) -> np.ndarray:
    """Row-wise regression targets (see ops/boxes.py::bbox_transform)."""
    ew = ex[:, 2] - ex[:, 0] + offset
    eh = ex[:, 3] - ex[:, 1] + offset
    ecx = ex[:, 0] + 0.5 * ew
    ecy = ex[:, 1] + 0.5 * eh
    gw = gt[:, 2] - gt[:, 0] + offset
    gh = gt[:, 3] - gt[:, 1] + offset
    gcx = gt[:, 0] + 0.5 * gw
    gcy = gt[:, 1] + 0.5 * gh
    return np.stack(
        [(gcx - ecx) / ew, (gcy - ecy) / eh, np.log(gw / ew), np.log(gh / eh)],
        axis=1,
    ).astype(np.float32)
