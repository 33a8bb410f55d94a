"""Faster R-CNN with a Feature Pyramid Network on ResNet-101 (Lin et al.,
arXiv:1612.03144; Detectron's ``e2e_faster_rcnn_R-101-FPN_2x.yaml``): the
trunk runs the stem and 3, 4, 23 and 3 bottlenecks over the image (conv5_x
at stride 32), each with frozen BatchNorm; C2 to C5 are each stage's last
output. The pathway: a 1x1 lateral conv with bias from each C_k to 256
channels; top down from C5, the coarser sum upsampled to the lateral's size
by nearest neighbour and added to it; a 3x3 pad-1 output conv with bias on
each sum: the pyramid P2 to P5 at strides 4, 8, 16 and 32, finest first.

Each box pools from its own level (``pool``): FPN's eq. 1, k = floor(4 +
log2(sqrt(wh) / 224)) clamped to 2..5, with w and h the box's +1 sides on
the scaled image (Detectron's), in its threshold form (``levels_of``: the
+1 area against 112**2, 224**2 and 448**2, in float32); ROI align at
``POOL_SIZE`` on that level's map at 1/stride. The head is fc6 (7 x 7 x 256
= 12544 inputs to ``FC_DIM``), fc7 and the output layers
(``nets.fc_head``). ``FEAT_STRIDE`` is not read.

Built on ``resnet50.py``'s stage arithmetic (``trunk_specs``, ``stage``,
``stem_flops``, ``stage_flops``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import nets

R50 = nets.network_module("resnet50")
STAGES = (3, 4, 23, 3)  # bottlenecks of conv2_x .. conv5_x
LEVELS = (2, 3, 4, 5)  # P2 .. P5
STRIDES = tuple(2 ** k for k in LEVELS)
C_OUT = (256, 512, 1024, 2048)  # C2 .. C5's channels
WIDTH = 256  # the pyramid's channels
TINY = {}  # the network whole at the tests' size


def param_specs(model: dict, kind: str):
    trunk_p, _ = R50.trunk_specs(STAGES)
    for k, c in zip(LEVELS, C_OUT):
        trunk_p += [(f"trunk.fpn_lateral{k}.weight", (WIDTH, c, 1, 1), "fan_in"),
                    (f"trunk.fpn_lateral{k}.bias", (WIDTH,), "bias"),
                    (f"trunk.fpn_output{k}.weight", (WIDTH, WIDTH, 3, 3), "fan_in"),
                    (f"trunk.fpn_output{k}.bias", (WIDTH,), "bias")]
    return trunk_p + nets.fc_head_specs(model, kind, WIDTH)


def trunk(model: dict, p: dict, x: torch.Tensor, q) -> tuple:
    """``[B, H, W, 3]`` -> ``(P2, P3, P4, P5)``, each ``[B, H/s, W/s, 256]``."""
    x = x.permute(0, 3, 1, 2)
    x = F.relu(nets.frozen_bn(p, "trunk.bn1",
                              nets.conv(x, p["trunk.conv1.weight"], q=q, stride=2, padding=3)))
    x = F.max_pool2d(x, 3, 2, padding=1)
    c = []
    for s, n in enumerate(STAGES):
        x = R50.stage(p, "trunk", s, n, x, q, 2 if s > 0 else 1)
        c.append(x)
    top, pyramid = None, []
    for k, ck in zip(reversed(LEVELS), reversed(c)):
        lat = nets.conv(ck, p[f"trunk.fpn_lateral{k}.weight"], p[f"trunk.fpn_lateral{k}.bias"], q)
        top = lat if top is None else lat + F.interpolate(top, size=lat.shape[-2:], mode="nearest")
        pyramid.insert(0, nets.conv(top, p[f"trunk.fpn_output{k}.weight"],
                                    p[f"trunk.fpn_output{k}.bias"], q, padding=1))
    return tuple(y.permute(0, 2, 3, 1) for y in pyramid)


def levels_of(rois: torch.Tensor) -> torch.Tensor:
    """Each box's level index (0 for P2) by FPN's eq. 1 in its threshold
    form: the count of 112**2, 224**2 and 448**2 that the +1 area ``(x2 - x1
    + 1) * (y2 - y1 + 1)`` of ``rois [R, 4]`` (float32) reaches."""
    rois = rois.float()
    area = (rois[:, 2] - rois[:, 0] + 1.0) * (rois[:, 3] - rois[:, 1] + 1.0)
    level = torch.zeros(rois.shape[0], dtype=torch.long, device=rois.device)
    for s in STRIDES[1:]:
        level += area >= (224.0 * s / 16) ** 2
    return level


def pool(model: dict, feat, rois: torch.Tensor, q) -> torch.Tensor:
    """Each box pooled from its own level (``levels_of``), the levels rounded
    by ``q``: ``[R, P, P, 256]`` in the boxes' order."""
    size = model["POOL_SIZE"]
    level = levels_of(rois)
    out = rois.new_zeros((rois.shape[0], size, size, nets.channels(feat)))
    for j, (fmap, stride) in enumerate(zip(nets.each_level(q, feat), STRIDES)):
        idx = (level == j).nonzero()[:, 0]
        if idx.numel():
            out[idx] = nets.roi_align(fmap, rois[idx], stride, size)
    return out


head = nets.fc_head


def head_outputs(kind: str, model: dict) -> dict:
    return nets.output_layers(kind, model)


def head_input_weights(model: dict, kind: str):
    return nets.FC_HEAD_INPUT


def trunk_flops(model: dict, canvas) -> float:
    """The stem and the four stages (``resnet50.py``'s count), then each
    level's lateral 1x1 and output 3x3 convs (the upsample and add are no
    multiply-adds)."""
    flops, h, w = R50.stem_flops(*canvas)
    c, sizes = 64, []
    for s, n in enumerate(STAGES):
        f, h, w, c = R50.stage_flops(h, w, s, n, c, 2 if s > 0 else 1)
        flops += f
        sizes.append(h * w)
    for hw, ck in zip(sizes, C_OUT):
        flops += 2.0 * hw * (ck * WIDTH + 9 * WIDTH * WIDTH)
    return flops


def head_flops(model: dict, kind: str, rows: int) -> float:
    """fc6, fc7 and the output dot over ``rows`` boxes."""
    return nets.dense_flops(param_specs(model, kind), rows)
