"""Small trunks (counterpart of ``aznet_tpu/models/small.py``): CaffeNet,
VGG_CNN_M_1024 and the CI stand-in ``SmallTrunk``.

NHWC in and out, like the reference; inside, the NHWC tensor is viewed as
NCHW (channels-last memory, what cuDNN runs fastest) and viewed back. Every
SAME conv with a stride pads as XLA does, through :func:`pad_same` (11x11/4
on 608 pads (3, 4); 7x7/2 and 5x5/2 on an even size pad (2, 3) and (1, 2));
stride-1 SAME convs pad symmetrically, so ``padding=k // 2`` is exact there.
The compute dtype is ``dtype`` (the config's; None: the parameters'
dtype), weights and biases cast to it inside ``forward`` (:func:`conv`; a
no-op on an inference net, whose weights the API casts once); the LRN runs
in float32, as the reference's. Float32 convolutions run in true
float32 whatever the caller's TF32 flags (``utils/precision.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aznet_tpu_torch.utils.precision import float32_precision


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


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """``layer`` applied to NCHW ``x`` with its weight and bias cast to
    ``dtype``: the module itself (forward hooks fire, as calibration needs)
    when they are of that dtype already."""
    if layer.weight.dtype == dtype:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x, layer.weight.to(dtype), bias, layer.stride, layer.padding,
                    layer.dilation, layer.groups)


def lrn(x: torch.Tensor, size: int = 5, alpha: float = 1e-4, beta: float = 0.75,
        k: float = 1.0, dim: int = -1) -> torch.Tensor:
    """Caffe cross-channel LRN along ``dim``: ``x / (k + (alpha / size) *
    window_sum(x**2)) ** beta``, the window ``size`` channels centred on each
    channel (zero beyond the edges), computed in float32 as the reference
    writes it and returned in ``x``'s dtype. (``F.local_response_norm``
    divides in another order.)"""
    xf = x.float().movedim(dim, -1)
    sq = F.pad(xf * xf, (size // 2, size - 1 - size // 2))
    c = xf.shape[-1]
    ssum = sq[..., 0:c]
    for i in range(1, size):
        ssum = ssum + sq[..., i:i + c]
    return (xf / (k + (alpha / size) * ssum) ** beta).movedim(-1, dim).to(x.dtype)


def _pool3x2(x: torch.Tensor) -> torch.Tensor:
    """Caffe's ceil-mode 3x3/2 max pool of NCHW ``x``: the bottom and right
    padded by one ``-inf``, then a 3x3/2 pool (Flax's ``((0, 1), (0, 1))``
    padding, by construction)."""
    return F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2)


class CaffeNetTrunk(nn.Module):
    """AlexNet-style trunk: ``[B, H, W, 3]`` -> ``[B, H/16, W/16, 256]``.
    conv1 11x11/4, pool, LRN, conv2 5x5 (2 groups), pool, LRN, conv3 3x3,
    conv4 and conv5 3x3 (2 groups), each conv followed by a ReLU."""

    feat_stride = 16
    out_channels = 256

    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 96, 11, stride=4)
        self.conv2 = nn.Conv2d(96, 256, 5, padding=2, groups=2)
        self.conv3 = nn.Conv2d(256, 384, 3, padding=1)
        self.conv4 = nn.Conv2d(384, 384, 3, padding=1, groups=2)
        self.conv5 = nn.Conv2d(384, 256, 3, padding=1, groups=2)

    @float32_precision()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or self.conv1.weight.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.relu(conv(self.conv1, pad_same(x, 11, 4), dt))
        x = lrn(_pool3x2(x), dim=1)
        x = F.relu(conv(self.conv2, x, dt))
        x = lrn(_pool3x2(x), dim=1)
        for layer in (self.conv3, self.conv4, self.conv5):
            x = F.relu(conv(layer, x, dt))
        return x.permute(0, 2, 3, 1)


class VGGCNNM1024Trunk(nn.Module):
    """VGG_CNN_M_1024 trunk: ``[B, H, W, 3]`` -> ``[B, H/16, W/16, 512]``.
    conv1 7x7/2, LRN, pool, conv2 5x5/2, LRN, pool, three 512-channel 3x3
    convs, each conv followed by a ReLU (pair with ``MODEL.FC7_DIM`` 1024)."""

    feat_stride = 16
    out_channels = 512

    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 96, 7, stride=2)
        self.conv2 = nn.Conv2d(96, 256, 5, stride=2)
        self.conv3 = nn.Conv2d(256, 512, 3, padding=1)
        self.conv4 = nn.Conv2d(512, 512, 3, padding=1)
        self.conv5 = nn.Conv2d(512, 512, 3, padding=1)

    @float32_precision()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or self.conv1.weight.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = _pool3x2(lrn(F.relu(conv(self.conv1, pad_same(x, 7, 2), dt)), dim=1))
        x = _pool3x2(lrn(F.relu(conv(self.conv2, pad_same(x, 5, 2), dt)), dim=1))
        for layer in (self.conv3, self.conv4, self.conv5):
            x = F.relu(conv(layer, x, dt))
        return x.permute(0, 2, 3, 1)


class SmallTrunk(nn.Module):
    """NHWC ``[B, H, W, 3]`` -> ``[B, H/16, W/16, out_channels]``: five
    SAME convs at stride 16 overall, for tests."""

    feat_stride = 16

    def __init__(self, width: int = 64, out_channels: int = 128, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.out_channels = out_channels
        self.conv1 = nn.Conv2d(3, width, 5, stride=2)
        self.conv2 = nn.Conv2d(width, width * 2, 3, stride=2)
        self.conv3 = nn.Conv2d(width * 2, width * 2, 3, padding=1)
        self.conv4 = nn.Conv2d(width * 2, out_channels, 3, padding=1)

    @float32_precision()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or self.conv1.weight.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.relu(conv(self.conv1, pad_same(x, 5, 2), dt))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(conv(self.conv2, pad_same(x, 3, 2), dt))
        x = F.relu(conv(self.conv3, x, dt))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(conv(self.conv4, x, dt))
        return x.permute(0, 2, 3, 1)
