"""ResNet-101 C4 (arXiv:1512.03385: Table 1's 101-layer column, Appendix
A's Faster R-CNN baseline): conv1 to conv4_x shared over the image (the
stem, then 3, 4 and 23 bottlenecks; stride 16, 1024 channels), and on each
``POOL_SIZE`` x ``POOL_SIZE`` ROI-align pool (14 x 14) conv5_x in the place
of fc6 and fc7: three bottlenecks 512 wide inside and 2048 out, the first at
stride 2 in its 3x3 conv (``SAME`` padding) and projected by a stride-2 1x1,
each conv followed by a frozen BatchNorm; then the mean over the 7x7 output
and the output layers as one dot (``nets.output_dot``). ``FC_DIM`` and
``FC7_DIM`` are not read.

Built on ``resnet50.py``'s stage arithmetic (``trunk_specs``,
``stage_specs``, ``stage``, ``stem_flops``, ``stage_flops``); the head's
parameters sit under ``head.fc.``, where the system keeps its head stack."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import nets

R50 = nets.network_module("resnet50")
STAGES = (3, 4, 23)  # bottlenecks of conv2_x .. conv4_x
HEAD_STAGE, HEAD_BLOCKS = 3, 3  # conv5_x
# The weights that take the pooled features: conv5_1's 1x1 and its projection.
HEAD_INPUT = ("head.fc.layer4_block0.conv1.weight", "head.fc.layer4_block0.downsample.weight")
TINY = {}  # the network whole at the tests' size


def param_specs(model: dict, kind: str):
    trunk_p, c = R50.trunk_specs(STAGES)
    head_p, d = R50.stage_specs("head.fc", HEAD_STAGE, HEAD_BLOCKS, c)
    return trunk_p + head_p + nets.output_specs(kind, model, d)


def trunk(model: dict, p: dict, x: torch.Tensor, q) -> torch.Tensor:
    """``[B, H, W, 3]`` -> conv4_x features ``[B, H/16, W/16, 1024]``."""
    x = x.permute(0, 3, 1, 2)
    x = F.relu(nets.frozen_bn(p, "trunk.bn1",
                              nets.conv(x, p["trunk.conv1.weight"], q=q, stride=2, padding=3)))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for s, n in enumerate(STAGES):
        x = R50.stage(p, "trunk", s, n, x, q, 2 if s > 0 else 1)
    return x.permute(0, 2, 3, 1)


def head(model: dict, kind: str, p: dict, pooled: torch.Tensor, q) -> dict:
    """conv5_x on ``[R, P, P, 1024]`` pools, the mean over its output, the
    output layers."""
    x = R50.stage(p, "head.fc", HEAD_STAGE, HEAD_BLOCKS, pooled.permute(0, 3, 1, 2), q, 2)
    return nets.output_dot(model, kind, p, x.mean((2, 3)), q)


def head_outputs(kind: str, model: dict) -> dict:
    return nets.output_layers(kind, model)


def head_input_weights(model: dict, kind: str):
    return HEAD_INPUT


def trunk_flops(model: dict, canvas) -> float:
    flops, h, w = R50.stem_flops(*canvas)
    c = 64
    for s, n in enumerate(STAGES):
        f, h, w, c = R50.stage_flops(h, w, s, n, c, 2 if s > 0 else 1)
        flops += f
    return flops


def head_flops(model: dict, kind: str, rows: int) -> float:
    """conv5_x's convolutions on each ``POOL_SIZE`` pool (1.618 GFLOP a box at
    14 x 14) and the output dot, over ``rows`` boxes."""
    side = model["POOL_SIZE"]
    conv5, _, _, c = R50.stage_flops(side, side, HEAD_STAGE, HEAD_BLOCKS, 1024, 2)
    return rows * conv5 + nets.dense_flops(nets.output_specs(kind, model, c), rows)
