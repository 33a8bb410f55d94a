"""ResNet-50 trunk to its C4 stage (counterpart of
``aznet_tpu/models/resnet.py``): ``[B, H, W, 3]`` -> ``[B, H/16, W/16,
1024]``, the float path and the int8 path.

Module names follow the reference's parameter tree (``conv1``, ``bn1``,
``layer{s}_block{b}.{conv1, bn1, conv2, bn2, conv3, bn3, downsample,
downsample_bn}``), so converted weights load one to one. NHWC in and out;
inside, the NHWC tensor is viewed as NCHW in channels-last memory.

- The stem is the plain 7x7/2 conv with (3, 3) padding. The reference's
  ``STEM_S2D`` rewrite computes the same terms (its own tests hold the two
  equal), so the port ignores it (``models/aznet.py`` warns once).
- ``FrozenBN`` is the inference BatchNorm, ``x * scale + bias`` in the
  compute dtype (two roundings in bf16, as the reference's).
- The first block of stages 2 and 3 has a stride-2 3x3 conv with XLA's
  SAME padding: (0, 1) on an even size (``pad_same``), not (1, 1).
- Compute dtype: ``dtype`` (the config's; None: the parameters' dtype),
  each weight cast to it inside ``forward`` (a no-op on an inference net,
  whose weights are cast already); in int8 mode bf16, with the parameters
  kept float32 (the int8 layers quantize them), as the reference's int8
  trunk does. The int8 path has no gradient: with autograd recording it
  raises.
  Float32 convolutions run in true float32 whatever the caller's TF32
  flags (``utils/precision.py``).

Int8 mode (``int8_scales``, two per block: the block input's and the
post-bn2-ReLU mid activation's, from ``ops/quant.py``): the three 1x1 convs
of a block (conv1, conv3, the downsample) are int8 GEMMs with int32 sums
(``ops/conv_int8.py::conv1x1_int8``). The block input is quantized once for
conv1 and the downsample; the mid activation is requantized for conv3. The
stem and the 3x3 convs stay bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aznet_tpu_torch.models.small import pad_same
from aznet_tpu_torch.ops import refuse_grad
from aznet_tpu_torch.ops.conv_int8 import conv1x1_int8, quantize_acts, quantize_weights_1x1
from aznet_tpu_torch.utils.precision import float32_precision

STAGE_SIZES = (3, 4, 6)  # C2, C3, C4 (C5 is not used at stride 16)


class FrozenBN(nn.Module):
    """Per-channel affine on NCHW ``x``: ``x * scale + bias``, both cast to
    ``x``'s dtype first."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x * self.scale.to(x.dtype)[:, None, None]
                + self.bias.to(x.dtype)[:, None, None])


def _conv1x1(c_in: int, c_out: int, stride: int = 1) -> nn.Conv2d:
    # A 1x1/SAME conv at stride s reads positions 0, s, 2s, ... (no padding).
    return nn.Conv2d(c_in, c_out, 1, stride=stride, bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4 channels), each with a FrozenBN, and a
    1x1 projection of the input when the shape changes."""

    def __init__(self, c_in: int, channels: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv1x1(c_in, channels)
        self.bn1 = FrozenBN(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, stride=stride, bias=False)
        self.bn2 = FrozenBN(channels)
        self.conv3 = _conv1x1(channels, channels * 4)
        self.bn3 = FrozenBN(channels * 4)
        if c_in != channels * 4 or stride != 1:
            self.downsample = _conv1x1(c_in, channels * 4, stride)
            self.downsample_bn = FrozenBN(channels * 4)
        else:
            self.downsample = None
        self._int8 = None

    def _conv2(self, y: torch.Tensor) -> torch.Tensor:
        w = self.conv2.weight.to(y.dtype)
        if self.stride == 1:
            return F.conv2d(y, w, padding=1)
        return F.conv2d(pad_same(y, 3, self.stride), w, stride=self.stride)

    def forward(self, x: torch.Tensor, int8_scales: tuple = ()) -> torch.Tensor:
        """NCHW ``x`` in the compute dtype; ``int8_scales = (s_in, s_mid)``
        selects the int8 1x1 convs."""
        if int8_scales:
            return self._int8_forward(x, *int8_scales)
        dt = x.dtype
        y = F.relu(self.bn1(F.conv2d(x, self.conv1.weight.to(dt))))
        y = F.relu(self.bn2(self._conv2(y)))
        y = self.bn3(F.conv2d(y, self.conv3.weight.to(dt)))
        residual = x
        if self.downsample is not None:
            residual = self.downsample_bn(
                F.conv2d(x, self.downsample.weight.to(dt), stride=self.stride))
        return F.relu(y + residual)

    def prepare_int8(self) -> None:
        """Quantize the 1x1 weights once, per output channel, from their
        float32 values."""
        convs = {"conv1": self.conv1, "conv3": self.conv3}
        if self.downsample is not None:
            convs["downsample"] = self.downsample
        self._int8 = {name: quantize_weights_1x1(conv.weight.detach())
                      for name, conv in convs.items()}

    def _int8_forward(self, x: torch.Tensor, s_in: float, s_mid: float) -> torch.Tensor:
        if self._int8 is None:
            raise RuntimeError("int8 weights are not quantized: call prepare_int8() "
                               "after loading the trunk's weights")
        dt = x.dtype

        def conv(x8, s_x, name, stride=1):  # NCHW int8 -> NCHW ``dt``
            w_q, s_w = self._int8[name]
            x8 = x8[:, :, ::stride, ::stride].permute(0, 2, 3, 1)
            return conv1x1_int8(x8, s_x, w_q, s_w, out_dtype=dt).permute(0, 3, 1, 2)

        xq = quantize_acts(x, s_in)
        y = F.relu(self.bn1(conv(xq, s_in, "conv1")))
        y = F.relu(self.bn2(self._conv2(y)))
        y = self.bn3(conv(quantize_acts(y, s_mid), s_mid, "conv3"))
        residual = x
        if self.downsample is not None:
            residual = self.downsample_bn(conv(xq, s_in, "downsample", self.stride))
        return F.relu(y + residual)


class ResNet50Trunk(nn.Module):
    """``[B, H, W, 3]`` -> C4 features ``[B, H/16, W/16, 1024]``.

    ``int8_mode`` with ``int8_scales`` (2 per block, block order; a trailing
    trunk-output scale may follow and is not used here) selects the int8 1x1
    convs."""

    feat_stride = 16
    out_channels = 1024

    def __init__(self, int8_mode: bool = False, int8_scales: tuple = (), dtype=None):
        super().__init__()
        self.dtype = dtype
        self.int8_mode = int8_mode
        self.int8_scales = tuple(int8_scales)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBN(64)
        c_in = 64
        self.block_names = []
        for stage, n in enumerate(STAGE_SIZES):
            channels = 64 * 2 ** stage
            for b in range(n):
                name = f"layer{stage + 1}_block{b}"
                stride = 2 if stage > 0 and b == 0 else 1
                self.add_module(name, Bottleneck(c_in, channels, stride))
                self.block_names.append(name)
                c_in = channels * 4

    def blocks(self):
        return [getattr(self, n) for n in self.block_names]

    def prepare_int8(self) -> None:
        for block in self.blocks():
            block.prepare_int8()

    @float32_precision()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.block_names)
        scales = ()
        if self.int8_mode:
            if len(self.int8_scales) < 2 * n:
                raise ValueError(
                    f"int8 ResNet trunk needs MODEL.INT8_SCALES with {2 * n} entries (2 per "
                    "bottleneck; run aznet_tpu_torch.ops.quant.calibrate_trunk_int8_resnet "
                    f"first); got {len(self.int8_scales)}")
            scales = self.int8_scales
            refuse_grad("COMPUTE_DTYPE='int8' (the int8 trunk)", x, *self.parameters())
        dt = torch.bfloat16 if self.int8_mode else self.dtype or self.conv1.weight.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(F.conv2d(x, self.conv1.weight.to(dt), stride=2, padding=3)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for i, block in enumerate(self.blocks()):
            x = block(x, tuple(scales[2 * i:2 * i + 2]))
        return x.permute(0, 2, 3, 1)
