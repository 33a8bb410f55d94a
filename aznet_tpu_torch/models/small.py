"""Small CI trunk (counterpart of ``aznet_tpu/models/small.py::SmallTrunk``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """JAX/TF ``SAME`` padding of NCHW ``x`` for a ``k``x``k``/stride ``s``
    conv. With stride 2 it is ASYMMETRIC: the extra row/column goes to the
    bottom/right (5x5/s2 on an even size pads (1, 2); 3x3/s2 pads (0, 1)),
    whereas ``nn.Conv2d(padding=...)`` pads symmetrically and would shift
    every output sample by one input pixel."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: W then H
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SmallTrunk(nn.Module):
    """NHWC ``[B, H, W, 3]`` -> ``[B, H/16, W/16, out_channels]``: five
    SAME convs at stride 16 overall, for tests."""

    feat_stride = 16

    def __init__(self, width: int = 64, out_channels: int = 128):
        super().__init__()
        self.out_channels = out_channels
        self.conv1 = nn.Conv2d(3, width, 5, stride=2)
        self.conv2 = nn.Conv2d(width, width * 2, 3, stride=2)
        self.conv3 = nn.Conv2d(width * 2, width * 2, 3, padding=1)
        self.conv4 = nn.Conv2d(width * 2, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.conv1(pad_same(x, 5, 2)))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.conv2(pad_same(x, 3, 2)))
        x = F.relu(self.conv3(x))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.conv4(x))
        return x.permute(0, 2, 3, 1)
