"""Plain PyTorch reference of Faster R-CNN with a Feature Pyramid Network on
ResNet-101 (Lin et al., arXiv:1612.03144; Detectron's R-101-FPN baseline),
in float32 with TF32 off, for the port's tests. It imports nothing of the
port and nothing of JAX (the pieces it shares with the C4 detector come from
``tests/reference_resnet101_c4.py``, which imports neither), so that its
answers are its own.

- The trunk: ResNet-101's stem and 3, 4, 23 and 3 bottlenecks (conv5_x over
  the image at stride 32), the first of conv3_x to conv5_x at stride 2 in
  its 3x3 conv with SAME padding; C2 to C5 each stage's last output.
- The pathway: 1x1 laterals with bias to 256 channels, top down the coarser
  sum upsampled by nearest neighbour to the lateral's size and added, 3x3
  pad-1 output convs with bias: P2 to P5, finest first.
- Each box's level by FPN's eq. 1, k = floor(4 + log2(sqrt(wh) / 224))
  clamped to 2..5, w and h the +1 sides on the scaled image: as Detectron
  computes it (``levels_eq1``: ``log2(sqrt(area) / 224 + 1e-6)``) and in
  its threshold form (``levels``: the +1 area against 112**2, 224**2 and
  448**2).
- ROI align (arXiv:1703.06870) at ``pool`` x ``pool`` bins on the box's
  level at 1/stride; fc6, fc7 (ReLU each) and the output layers as one dot.
- The preprocess and the decode of the C4 reference.

Tensors are NHWC at the boundaries; the parameters a flat dict under the
port's names (``trunk.layer4_block2.conv3.weight``,
``trunk.fpn_lateral2.bias``, ``head.fc.fc6.weight``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference_resnet101_c4 import (_bin_weights, canvas_for, compute_scale,  # noqa: F401
                                    decode, frozen_bn, ieee_fp32, preprocess, stage)

STAGES = (3, 4, 23, 3)  # conv2_x .. conv5_x
LEVELS = (2, 3, 4, 5)
STRIDES = (4, 8, 16, 32)
OUTPUTS = ("cls_score", "bbox_pred")


def trunk(p: dict, x: torch.Tensor) -> tuple:
    """``[B, H, W, 3]`` -> ``(P2, P3, P4, P5)``, each ``[B, H/s, W/s, 256]``."""
    with ieee_fp32():
        x = x.float().permute(0, 3, 1, 2)
        x = F.relu(frozen_bn(p, "trunk.bn1", F.conv2d(x, p["trunk.conv1.weight"], stride=2,
                                                      padding=3)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        c = []
        for s, n in enumerate(STAGES):
            x = stage(p, "trunk", s, n, x, 2 if s > 0 else 1)
            c.append(x)
        top, pyramid = None, []
        for k, ck in zip(reversed(LEVELS), reversed(c)):
            lat = F.conv2d(ck, p[f"trunk.fpn_lateral{k}.weight"], p[f"trunk.fpn_lateral{k}.bias"])
            if top is not None:
                lat = lat + F.interpolate(top, size=lat.shape[-2:], mode="nearest")
            top = lat
            pyramid.insert(0, F.conv2d(top, p[f"trunk.fpn_output{k}.weight"],
                                       p[f"trunk.fpn_output{k}.bias"], padding=1))
        return tuple(y.permute(0, 2, 3, 1) for y in pyramid)


def levels(rois: torch.Tensor) -> torch.Tensor:
    """Each box's level index (0 for P2), eq. 1 in its threshold form: how
    many of 112**2, 224**2 and 448**2 the float32 +1 area reaches."""
    rois = rois.float()
    area = (rois[:, 2] - rois[:, 0] + 1.0) * (rois[:, 3] - rois[:, 1] + 1.0)
    return sum((area >= side ** 2).long() for side in (112.0, 224.0, 448.0))


def levels_eq1(rois: torch.Tensor) -> torch.Tensor:
    """Each box's level index by eq. 1 as Detectron computes it, in float64:
    ``floor(4 + log2(sqrt(area) / 224 + 1e-6))`` clamped to 2..5, less 2."""
    r = rois.double()
    area = (r[:, 2] - r[:, 0] + 1.0) * (r[:, 3] - r[:, 1] + 1.0)
    k = torch.floor(4 + torch.log2(area.sqrt() / 224.0 + 1e-6)).clamp(LEVELS[0], LEVELS[-1])
    return (k - LEVELS[0]).long()


def roi_align(feat: torch.Tensor, rois: torch.Tensor, stride: int, pool: int = 7) -> torch.Tensor:
    """``feat [H, W, C]``, ``rois [R, 4]`` in image coordinates -> ``[R, pool,
    pool, C]`` at ``1 / stride``."""
    h, w, _ = feat.shape
    with ieee_fp32():
        x1, y1, x2, y2 = (rois.float() * (1.0 / stride)).unbind(-1)
        wy = _bin_weights(y1, (y2 - y1).clamp(min=1.0), h, pool)
        wx = _bin_weights(x1, (x2 - x1).clamp(min=1.0), w, pool)
        rows = torch.einsum("rph,hwc->rpwc", wy, feat.float())
        return torch.einsum("rqw,rpwc->rpqc", wx, rows).contiguous()


def pool(feat: tuple, rois: torch.Tensor, pool_size: int = 7) -> torch.Tensor:
    """One image's levels and ``rois [R, 4]`` -> ``[R, P, P, 256]``, each box
    pooled from its own level, in the boxes' order."""
    level = levels(rois)
    out = torch.zeros(rois.shape[0], pool_size, pool_size, feat[0].shape[-1],
                      device=rois.device)
    for j, (fmap, stride) in enumerate(zip(feat, STRIDES)):
        idx = (level == j).nonzero()[:, 0]
        if idx.numel():
            out[idx] = roi_align(fmap, rois[idx], stride, pool_size)
    return out


def head(p: dict, pooled: torch.Tensor) -> dict:
    """fc6 -> ReLU -> fc7 -> ReLU -> the output layers as one dot:
    ``cls_score``, ``bbox_pred``."""
    with ieee_fp32():
        x = pooled.float().reshape(pooled.shape[0], -1)
        for fc in ("fc6", "fc7"):
            x = F.relu(F.linear(x, p[f"head.fc.{fc}.weight"], p[f"head.fc.{fc}.bias"]))
        w = torch.cat([p[f"head.{n}.weight"] for n in OUTPUTS])
        b = torch.cat([p[f"head.{n}.bias"] for n in OUTPUTS])
        y = F.linear(x, w, b)
    c = p["head.cls_score.weight"].shape[0]
    return {"cls_score": y[:, :c], "bbox_pred": y[:, c:]}


def roi_forward(p: dict, feat: tuple, rois: torch.Tensor, pool_size: int = 7) -> dict:
    return head(p, pool(feat, rois, pool_size))


def detect(p: dict, images: torch.Tensor, boxes: torch.Tensor, canvas, target: int,
           max_size: int, means, pool_size: int = 7) -> tuple:
    """Raw ``images [B, H, W, 3]`` and ``boxes [B, R, 4]`` (original
    coordinates) on a ``canvas`` (h, w) -> ``(softmax scores [B, R, K],
    decoded boxes [B, R, 4K])``."""
    _, h, w, _ = images.shape
    scale = compute_scale(h, w, target, max_size)
    blobs = torch.stack([preprocess(im, means, scale, *canvas) for im in images])
    feats = trunk(p, blobs)
    scores, pred = [], []
    for i, b in enumerate(boxes):
        out = roi_forward(p, tuple(level[i] for level in feats), b.float() * scale, pool_size)
        scores.append(torch.softmax(out["cls_score"], -1))
        pred.append(decode(b.float(), out["bbox_pred"], float(h), float(w)))
    return torch.stack(scores), torch.stack(pred)

