"""Box transforms with Caffe/fast-rcnn conventions (``+offset`` widths).

Counterpart of ``aznet_tpu/ops/boxes.py``: ``box_area``,
``bbox_transform``, ``bbox_transform_inv`` (with its no-``-offset`` decode
quirk and the ``clip=BBOX_XFORM_CLIP`` bound on dw/dh), ``clip_boxes``,
``flip_boxes`` and ``scale_boxes``. Plain tensor functions, broadcast over
leading dims; ``[x1, y1, x2, y2]`` boxes.
"""

from __future__ import annotations

import torch


def box_wh(boxes, offset: float = 1.0):
    """Widths and heights of ``[..., 4]`` boxes."""
    return boxes[..., 2] - boxes[..., 0] + offset, boxes[..., 3] - boxes[..., 1] + offset


def box_area(boxes, offset: float = 1.0):
    w, h = box_wh(boxes, offset)
    return w * h


def box_ctr(boxes, offset: float = 1.0):
    w, h = box_wh(boxes, offset)
    return boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h, w, h


def bbox_transform(ex_rois, gt_rois, offset: float = 1.0):
    """Regression targets (dx, dy, dw, dh) taking ``ex_rois`` to ``gt_rois``."""
    ex_cx, ex_cy, ex_w, ex_h = box_ctr(ex_rois, offset)
    gt_cx, gt_cy, gt_w, gt_h = box_ctr(gt_rois, offset)
    return torch.stack([(gt_cx - ex_cx) / ex_w, (gt_cy - ex_cy) / ex_h,
                        torch.log(gt_w / ex_w), torch.log(gt_h / ex_h)], dim=-1)


def bbox_transform_inv(boxes, deltas, offset: float = 1.0, clip: float | None = None):
    """Decode ``deltas`` (``[..., 4K]`` groups or ``[..., K, 4]``) against
    ``boxes [..., 4]``; returns the shape of ``deltas``.

    ``x2 = ctr + 0.5*w`` with NO trailing ``-offset``: the reference decode
    quirk, kept for parity. ``clip`` bounds dw/dh before ``exp``."""
    flat_groups = deltas.shape[-1] != 4 or deltas.ndim == boxes.ndim
    if flat_groups:
        d = deltas.reshape(deltas.shape[:-1] + (deltas.shape[-1] // 4, 4))
    else:
        d = deltas
    cx, cy, w, h = (t[..., None] for t in box_ctr(boxes, offset))
    dx, dy, dw, dh = d.unbind(-1)
    if clip is not None:
        dw = dw.clamp(-clip, clip)
        dh = dh.clamp(-clip, clip)
    pred_cx = dx * w + cx
    pred_cy = dy * h + cy
    pred_w = torch.exp(dw) * w
    pred_h = torch.exp(dh) * h
    out = torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                       pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h], dim=-1)
    return out.reshape(deltas.shape) if flat_groups else out


def _clip(x, hi):
    """``jnp.clip(x, 0, hi)``, ``min(max(x, 0), hi)`` in ``x``'s dtype with NaN
    kept, for a Python or tensor upper bound. A Python bound stays a scalar
    of the launch: a CUDA tensor made from it would be a copy from the host
    that waits for the card."""
    if isinstance(hi, torch.Tensor):
        return torch.minimum(x.clamp(min=0.0), torch.as_tensor(hi, dtype=x.dtype,
                                                               device=x.device))
    return x.clamp(0.0, hi)


def clip_boxes(boxes, im_shape, offset: float = 1.0):
    """Clip ``[..., 4K]`` boxes to x in ``[0, W - offset]``, y in
    ``[0, H - offset]``. H and W are Python numbers, or tensors that
    broadcast over the leading dims (0-d, or ``[B, 1]`` for ``[B, R, 4K]``
    boxes: one extent an image)."""
    h, w = (t[..., None] if isinstance(t, torch.Tensor) else t for t in im_shape[:2])
    shape = boxes.shape
    b = boxes.reshape(shape[:-1] + (shape[-1] // 4, 4))
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([_clip(x1, w - offset), _clip(y1, h - offset),
                        _clip(x2, w - offset), _clip(y2, h - offset)], dim=-1).reshape(shape)


def flip_boxes(boxes, width, offset: float = 1.0):
    """Horizontal flip: ``x1' = W - x2 - offset`` (the reference's
    ``imdb.append_flipped_images`` convention)."""
    return torch.stack([width - boxes[..., 2] - offset, boxes[..., 1],
                        width - boxes[..., 0] - offset, boxes[..., 3]], dim=-1)


def scale_boxes(boxes, scale):
    """Project boxes between image and scaled coordinates."""
    return boxes * scale
