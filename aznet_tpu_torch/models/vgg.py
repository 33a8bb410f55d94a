"""VGG-16 trunk, conv1_1 .. conv5_3 at stride 16 (float path of
``aznet_tpu/models/vgg.py::VGG16Trunk``).

NHWC in and out, like the reference. Inside, the NHWC tensor is viewed as
NCHW in channels-last memory, which is what cuDNN's bf16 convolutions run
fastest on, and the output is viewed back without a copy. The 3x3/s1 SAME
padding is symmetric, so ``padding=1`` matches JAX exactly. The compute
dtype is the parameters' dtype (the API casts them once).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# (name, channels) per conv; None entries are 2x2/2 max pools.
VGG16_LAYOUT = (
    ("conv1_1", 64), ("conv1_2", 64), ("pool1", None),
    ("conv2_1", 128), ("conv2_2", 128), ("pool2", None),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("pool3", None),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("pool4", None),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
)


class VGG16Trunk(nn.Module):
    """``[B, H, W, 3]`` -> ``[B, H/16, W/16, max(int(512*width), 8)]``."""

    feat_stride = 16

    def __init__(self, width: float = 1.0):
        super().__init__()
        c_in = 3
        for name, ch in VGG16_LAYOUT:
            if ch is None:
                continue
            ch = max(int(ch * width), 8)
            self.add_module(name, nn.Conv2d(c_in, ch, 3, padding=1))
            c_in = ch
        self.out_channels = c_in

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.conv1_1.weight.dtype).permute(0, 3, 1, 2)
        for name, ch in VGG16_LAYOUT:
            if ch is None:
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, name)(x))
        return x.permute(0, 2, 3, 1)
