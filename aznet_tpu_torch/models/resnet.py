"""ResNet-50 trunk to its C4 stage (counterpart of
``aznet_tpu/models/resnet.py``): ``[B, H, W, 3]`` -> ``[B, H/16, W/16,
1024]``, the float path and the int8 path; ResNet-101 to the same stage
(3, 4 and 23 bottlenecks), the C4 detector's trunk, whose conv5_x runs on
each pooled roi (``models/heads.py::Conv5Stack``).

Module names follow the reference's parameter tree (``conv1``, ``bn1``,
``layer{s}_block{b}.{conv1, bn1, conv2, bn2, conv3, bn3, downsample,
downsample_bn}``), so converted weights load one to one. NHWC in and out;
inside, the NHWC tensor is viewed as NCHW in channels-last memory.

- The stem is the plain 7x7/2 conv with (3, 3) padding. The reference's
  ``STEM_S2D`` rewrite computes the same terms (its own tests hold the two
  equal), so the port ignores it (``models/aznet.py`` warns once).
- ``FrozenBN`` is the inference BatchNorm, ``x * scale + bias`` in the
  compute dtype (two roundings in bf16, as the reference's). After each
  convolution, its affine, the residual add and the ReLU run as one step,
  ``bn(y, relu=True, ...)`` (``ops/frozen_bn.py``): on the card one kernel
  launch that writes into the convolution's output, bit for bit with the
  separate operations, which run on the CPU and while autograd records.
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
from aznet_tpu_torch.ops.frozen_bn import frozen_bn_relu
from aznet_tpu_torch.utils.precision import float32_precision

STAGE_SIZES = (3, 4, 6)  # C2, C3, C4 (C5 is not used at stride 16)
RESNET101_STAGE_SIZES = (3, 4, 23)


class FrozenBN(nn.Module):
    """Per-channel affine on NCHW ``x``: ``x * scale + bias``, both cast to
    ``x``'s dtype first; with ``relu``, the epilogue after a convolution:
    ``relu(x * scale + bias + residual)``, ``residual`` passed through
    ``residual_bn``'s affine first where given, by
    ``ops/frozen_bn.py::frozen_bn_relu`` (on the card one kernel that writes
    into ``x``, a convolution's output that nothing else holds). A module
    call either way, so that forward hooks see the result (the int8
    calibration reads ``bn2``'s)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: torch.Tensor | None = None,
                residual_bn: FrozenBN | None = None) -> torch.Tensor:
        s, b = self.scale.to(x.dtype), self.bias.to(x.dtype)
        if not relu:
            return x * s[:, None, None] + b[:, None, None]
        affine = () if residual_bn is None else (residual_bn.scale.to(x.dtype),
                                                 residual_bn.bias.to(x.dtype))
        return frozen_bn_relu(x, s, b, residual, *affine)


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
        y = self.bn1(F.conv2d(x, self.conv1.weight.to(dt)), relu=True)
        y = self.bn2(self._conv2(y), relu=True)
        y = F.conv2d(y, self.conv3.weight.to(dt))
        if self.downsample is None:
            return self.bn3(y, relu=True, residual=x)
        d = F.conv2d(x, self.downsample.weight.to(dt), stride=self.stride)
        return self.bn3(y, relu=True, residual=d, residual_bn=self.downsample_bn)

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
        y = self.bn1(conv(xq, s_in, "conv1"), relu=True)
        y = self.bn2(self._conv2(y), relu=True)
        y = conv(quantize_acts(y, s_mid), s_mid, "conv3")
        if self.downsample is None:
            return self.bn3(y, relu=True, residual=x)
        return self.bn3(y, relu=True, residual=conv(xq, s_in, "downsample", self.stride),
                        residual_bn=self.downsample_bn)


def add_stage(module: nn.Module, stage: int, n: int, c_in: int, stride: int) -> tuple:
    """Add ``n`` bottlenecks of stage ``stage`` (0 is conv2_x; ``64 *
    2**stage`` wide inside, 4x that out) to ``module`` as
    ``layer{stage + 1}_block{b}``, the first at ``stride`` in its 3x3 conv
    and projected; ``(names, out_channels)``."""
    channels, names = 64 * 2 ** stage, []
    for b in range(n):
        name = f"layer{stage + 1}_block{b}"
        module.add_module(name, Bottleneck(c_in, channels, stride if b == 0 else 1))
        names.append(name)
        c_in = channels * 4
    return names, c_in


class ResNet50Trunk(nn.Module):
    """``[B, H, W, 3]`` -> C4 features ``[B, H/16, W/16, 1024]``.

    ``int8_mode`` with ``int8_scales`` (2 per block, block order; a trailing
    trunk-output scale may follow and is not used here) selects the int8 1x1
    convs. ``stage_sizes``: the bottlenecks of conv2_x to conv4_x
    (ResNet-50's by default)."""

    feat_stride = 16
    out_channels = 1024
    conv5_head = False

    def __init__(self, int8_mode: bool = False, int8_scales: tuple = (), dtype=None,
                 stage_sizes: tuple = STAGE_SIZES):
        super().__init__()
        self.dtype = dtype
        self.int8_mode = int8_mode
        self.int8_scales = tuple(int8_scales)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBN(64)
        c_in = 64
        self.block_names = []
        for stage, n in enumerate(stage_sizes):
            names, c_in = add_stage(self, stage, n, c_in, 2 if stage > 0 else 1)
            self.block_names += names

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
        x = self.bn1(F.conv2d(x, self.conv1.weight.to(dt), stride=2, padding=3), relu=True)
        x = F.max_pool2d(x, 3, 2, padding=1)
        for i, block in enumerate(self.blocks()):
            x = block(x, tuple(scales[2 * i:2 * i + 2]))
        return x.permute(0, 2, 3, 1)


class ResNet101Trunk(ResNet50Trunk):
    """ResNet-101 to conv4_x (3, 4 and 23 bottlenecks; conv4_x is
    ``layer3_block0`` to ``layer3_block22``): ``[B, H, W, 3]`` -> ``[B, H/16,
    W/16, 1024]``, the trunk of the ``resnet101_c4`` detector, whose heads
    run conv5_x on each pooled roi (``models/heads.py::Conv5Stack``)."""

    conv5_head = True

    def __init__(self, int8_mode: bool = False, int8_scales: tuple = (), dtype=None):
        super().__init__(int8_mode, int8_scales, dtype, RESNET101_STAGE_SIZES)
