"""VGG-16 configuration D to conv5_3 (arXiv:1409.1556): thirteen 3x3 convs
with ReLU, four 2x2/2 max pools, stride 16; ``WIDTH`` scales every layer's
channels (at least 8). The head is fc6, fc7 and the output layers on a
``POOL_SIZE`` x ``POOL_SIZE`` ROI-align pool (``nets.fc_head``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import nets

LAYOUT = (
    ("conv1_1", 64), ("conv1_2", 64), ("pool1", None),
    ("conv2_1", 128), ("conv2_2", 128), ("pool2", None),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("pool3", None),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("pool4", None),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
)
TINY = {"WIDTH": 0.125, "FC_DIM": 64}


def trunk_specs(width: float = 1.0):
    """``([(name, shape, kind)], out_channels)`` of the trunk."""
    out, c = [], 3
    for name, ch in LAYOUT:
        if ch is None:
            continue
        ch = max(int(ch * width), 8)
        out += [(f"trunk.{name}.weight", (ch, c, 3, 3), "fan_in"),
                (f"trunk.{name}.bias", (ch,), "bias")]
        c = ch
    return out, c


def param_specs(model: dict, kind: str):
    trunk_p, c = trunk_specs(model["WIDTH"])
    return trunk_p + nets.fc_head_specs(model, kind, c)


def trunk(model: dict, p: dict, x: torch.Tensor, q) -> torch.Tensor:
    """``[B, H, W, 3]`` -> ``[B, H/16, W/16, C]``."""
    x = x.permute(0, 3, 1, 2)
    for name, ch in LAYOUT:
        if ch is None:
            x = F.max_pool2d(x, 2, 2)
        else:
            x = F.relu(nets.conv(x, p[f"trunk.{name}.weight"], p[f"trunk.{name}.bias"], q,
                                 padding=1))
    return x.permute(0, 2, 3, 1)


head = nets.fc_head


def head_outputs(kind: str, model: dict) -> dict:
    return nets.output_layers(kind, model)


def head_input_weights(model: dict, kind: str):
    return nets.FC_HEAD_INPUT


def trunk_flops(model: dict, canvas) -> float:
    h, w = canvas
    flops, c = 0.0, 3
    for _, ch in LAYOUT:
        if ch is None:
            h, w = h // 2, w // 2
            continue
        ch = max(int(ch * model["WIDTH"]), 8)
        flops += 2.0 * h * w * 9 * c * ch
        c = ch
    return flops


def head_flops(model: dict, kind: str, rows: int) -> float:
    return nets.dense_flops(param_specs(model, kind), rows)
