"""ResNet-50 to its conv4_x stage (arXiv:1512.03385): the 7x7/2 stem and a
3x3/2 max pool, then 3, 4 and 6 bottlenecks (1x1, 3x3, 1x1 x4), the first
of stages 2 and 3 at stride 2 in its 3x3 conv, a 1x1 projection where the
shape changes, each conv followed by a frozen BatchNorm; stride 16, 1024
channels. The head is fc6, fc7 and the output layers on a ``POOL_SIZE`` x
``POOL_SIZE`` ROI-align pool (``nets.fc_head``).

The bottleneck stages (``stage_specs``, ``stage``, ``stage_flops``) take any
stage index, block count and name prefix, for a deeper network or one that
runs a stage on the pooled rois to load this module
(``nets.network_module("resnet50")``) and build on."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import nets

STAGES = (3, 4, 6)  # bottlenecks of conv2_x .. conv4_x
TINY = {"FC_DIM": 64}


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def stem_specs():
    return [("trunk.conv1.weight", (64, 3, 7, 7), "fan_in"), *nets.bn_specs("trunk.bn1", 64)]


def stage_specs(prefix: str, stage: int, n: int, c_in: int):
    """``([(name, shape, kind)], out_channels)`` of ``n`` bottlenecks of
    stage ``stage`` (0 for conv2_x; ``64 * 2**stage`` wide inside, 4x that
    out), named ``<prefix>.layer<stage + 1>_block<b>``."""
    ch, out = 64 * 2 ** stage, []
    for b in range(n):
        p = f"{prefix}.layer{stage + 1}_block{b}"
        out += [(f"{p}.conv1.weight", (ch, c_in, 1, 1), "fan_in"), *nets.bn_specs(f"{p}.bn1", ch),
                (f"{p}.conv2.weight", (ch, ch, 3, 3), "fan_in"), *nets.bn_specs(f"{p}.bn2", ch),
                (f"{p}.conv3.weight", (4 * ch, ch, 1, 1), "fan_in"),
                *nets.bn_specs(f"{p}.bn3", 4 * ch)]
        if b == 0:
            out += [(f"{p}.downsample.weight", (4 * ch, c_in, 1, 1), "fan_in"),
                    *nets.bn_specs(f"{p}.downsample_bn", 4 * ch)]
        c_in = 4 * ch
    return out, c_in


def trunk_specs(stages=STAGES):
    out, c = stem_specs(), 64
    for s, n in enumerate(stages):
        specs, c = stage_specs("trunk", s, n, c)
        out += specs
    return out, c


def param_specs(model: dict, kind: str):
    trunk_p, c = trunk_specs()
    return trunk_p + nets.fc_head_specs(model, kind, c)


def stage(p: dict, prefix: str, stage_i: int, n: int, x: torch.Tensor, q, stride: int) -> torch.Tensor:
    """``n`` bottlenecks on NCHW ``x``, the first at ``stride`` in its 3x3
    conv (``SAME`` padding there) and projected."""
    for b in range(n):
        pre = f"{prefix}.layer{stage_i + 1}_block{b}"
        s = stride if b == 0 else 1
        y = F.relu(nets.frozen_bn(p, f"{pre}.bn1", nets.conv(x, p[f"{pre}.conv1.weight"], q=q)))
        w2 = p[f"{pre}.conv2.weight"]
        y = (nets.conv(y, w2, q=q, padding=1) if s == 1
             else nets.conv(nets.pad_same(y, 3, 2), w2, q=q, stride=2))
        y = F.relu(nets.frozen_bn(p, f"{pre}.bn2", y))
        y = nets.frozen_bn(p, f"{pre}.bn3", nets.conv(y, p[f"{pre}.conv3.weight"], q=q))
        res = x
        if b == 0:
            res = nets.frozen_bn(p, f"{pre}.downsample_bn",
                                 nets.conv(x, p[f"{pre}.downsample.weight"], q=q, stride=s))
        x = F.relu(y + res)
    return x


def trunk(model: dict, p: dict, x: torch.Tensor, q) -> torch.Tensor:
    """``[B, H, W, 3]`` -> conv4_x features ``[B, H/16, W/16, 1024]``."""
    x = x.permute(0, 3, 1, 2)
    x = F.relu(nets.frozen_bn(p, "trunk.bn1",
                              nets.conv(x, p["trunk.conv1.weight"], q=q, stride=2, padding=3)))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for s, n in enumerate(STAGES):
        x = stage(p, "trunk", s, n, x, q, 2 if s > 0 else 1)
    return x.permute(0, 2, 3, 1)


head = nets.fc_head


def head_outputs(kind: str, model: dict) -> dict:
    return nets.output_layers(kind, model)


def head_input_weights(model: dict, kind: str):
    return nets.FC_HEAD_INPUT


def stem_flops(h: int, w: int) -> tuple:
    """``(flops, h, w)``: the 7x7/2 conv and the 3x3/2 max pool's output size."""
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    flops = 2.0 * h * w * 49 * 3 * 64
    return flops, _out(h, 3, 2, 1), _out(w, 3, 2, 1)


def stage_flops(h: int, w: int, stage_i: int, n: int, c_in: int, stride: int) -> tuple:
    """``(flops, h, w, out_channels)`` of ``stage``'s convolutions on an
    ``h`` x ``w`` input."""
    ch, flops = 64 * 2 ** stage_i, 0.0
    for b in range(n):
        s = stride if b == 0 else 1
        ho, wo = -(-h // s), -(-w // s)
        flops += 2.0 * h * w * c_in * ch + 2.0 * ho * wo * (9 * ch * ch + ch * 4 * ch)
        if b == 0:
            flops += 2.0 * ho * wo * c_in * 4 * ch
        h, w, c_in = ho, wo, 4 * ch
    return flops, h, w, c_in


def trunk_flops(model: dict, canvas) -> float:
    flops, h, w = stem_flops(*canvas)
    c = 64
    for s, n in enumerate(STAGES):
        f, h, w, c = stage_flops(h, w, s, n, c, 2 if s > 0 else 1)
        flops += f
    return flops


def head_flops(model: dict, kind: str, rows: int) -> float:
    return nets.dense_flops(param_specs(model, kind), rows)
