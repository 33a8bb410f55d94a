"""VGG-16 trunk, conv1_1 .. conv5_3 at stride 16
(``aznet_tpu/models/vgg.py::VGG16Trunk``): the float path and the int8 path.

NHWC in and out, like the reference. Float path: the NHWC tensor is viewed
as NCHW in channels-last memory, which is what cuDNN's bf16 convolutions run
fastest on, and the output is viewed back without a copy. The 3x3/s1 SAME
padding is symmetric, so ``padding=1`` matches JAX exactly. The compute
dtype is ``dtype`` (the config's; None: the parameters' dtype): weights,
biases and input are cast to it inside ``forward``, a no-op for an inference
net (the API casts the weights once) and the way gradients reach a training
net's float32 masters. Float32 runs in true float32 whatever the caller's
TF32 flags (``utils/precision.py``).

``fuse_conv1`` (``MODEL.FUSE_CONV1``, float path only): conv1_1, conv1_2 and
pool1 run through ``ops/conv1_fused.py`` (the CUDA kernel on the card, its
plain version on the CPU) when H % 32 == 0 and W % 2 == 0, the reference's
shape gate; other shapes run the plain layers. The int8 path ignores it, as
the reference's does.

Int8 path (``VGG16Trunk._int8_forward`` of the reference, inference only):
the bf16 prefix conv1_1, conv1_2 and conv2_1 (f32 accumulation and f32
bias); the prefix's last f32 output is quantized with its calibrated scale,
and every later conv runs on int8 activations. ``int8_backend``:

- ``'pallas'``: the int8 conv kernel (``ops/conv_int8.py::conv3x3_int8``).
  A pool after a conv is fused into it when the check of the reference's
  chain holds (every int8 layer's width a multiple of 128) and the map's h
  and w are even; otherwise it runs as a separate int8 max-pool (the
  odd-size fallback). With ``int8_chain_from='conv1_2'`` the prefix is
  conv1_1 alone when the chain check holds and conv1 is 64 wide (the
  reference's rule): conv1_1's f32 output is quantized, conv1_2 runs
  through the chain entry with pool1 fused (C = Co = 64) and conv2_1
  through the strip entry (C = 64). The reference pads those 64 channels
  to 128 lanes with zero weights and zero bias; the padded lanes stay zero
  through the ReLU, the pool and requantization and meet zero weight rows
  in conv2_1, so the compact 64-channel layout gives the same codes.
  Otherwise the setting has no effect, and the trunk warns once.
- ``'pallas_strip'``: the same kernel, every pool separate.
- ``'xla'``: the reference's portable trunk, each conv as three dx-packed
  int8 GEMMs (``ops/conv_int8.py::conv3x3_int8_dx``, ``torch._int_mm``)
  requantized by a true division, every pool separate.

conv5_3 exits in bf16. Weights are quantized once, from the float32
parameters, by :meth:`VGG16Trunk.prepare_int8`.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from aznet_tpu_torch.models.small import conv
from aznet_tpu_torch.ops import refuse_grad
from aznet_tpu_torch.ops.conv1_fused import fused_conv1_pool
from aznet_tpu_torch.ops.conv_int8 import (Int8Conv, conv3x3_int8, conv3x3_int8_dx,
                                           max_pool_2x2, quantize_acts, quantize_weights)
from aznet_tpu_torch.utils.precision import float32_precision

# (name, channels) per conv; None entries are 2x2/2 max pools.
VGG16_LAYOUT = (
    ("conv1_1", 64), ("conv1_2", 64), ("pool1", None),
    ("conv2_1", 128), ("conv2_2", 128), ("pool2", None),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("pool3", None),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("pool4", None),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
)

INT8_BACKENDS = ("pallas", "pallas_strip", "xla")
INT8_CHAIN_FROM = ("conv2_2", "conv1_2")


class VGG16Trunk(nn.Module):
    """``[B, H, W, 3]`` -> ``[B, H/16, W/16, max(int(512*width), 8)]``.

    ``int8_mode`` selects the int8 path with ``int8_scales`` (conv1_1 ..
    conv5_2, or all 13), ``int8_backend`` (``INT8_BACKENDS``) and
    ``int8_chain_from`` (``INT8_CHAIN_FROM``); ``int8_bf16_prefix`` is the
    prefix this trunk keeps in bf16 (module docstring)."""

    feat_stride = 16
    # The default bf16 prefix of the int8 path; its last output is quantized.
    _INT8_BF16_PREFIX = ("conv1_1", "conv1_2", "conv2_1")

    def __init__(self, width: float = 1.0, int8_mode: bool = False,
                 int8_scales: tuple = (), int8_backend: str = "pallas",
                 int8_chain_from: str = "conv2_2", fuse_conv1: bool = False, dtype=None):
        super().__init__()
        self.dtype = dtype
        c_in = 3
        for name, ch in VGG16_LAYOUT:
            if ch is None:
                continue
            ch = max(int(ch * width), 8)
            self.add_module(name, nn.Conv2d(c_in, ch, 3, padding=1))
            c_in = ch
        self.out_channels = c_in
        self.width = width
        self.int8_mode = int8_mode
        self.fuse_conv1 = fuse_conv1
        if int8_mode:
            if int8_chain_from not in INT8_CHAIN_FROM:
                raise ValueError(f"int8 trunk: MODEL.INT8_CHAIN_FROM must be one of "
                                 f"{INT8_CHAIN_FROM}, got {int8_chain_from!r}")
            if int8_backend not in INT8_BACKENDS:
                raise ValueError(f"COMPUTE_DTYPE='int8' takes MODEL.INT8_BACKEND in "
                                 f"{INT8_BACKENDS}, got {int8_backend!r}")
        self.int8_scales = tuple(int8_scales)
        self.int8_backend = int8_backend
        # The reference's chain check, on the default prefix's int8 layers.
        self.int8_chain = int8_backend == "pallas" and all(
            max(int(ch * width), 8) % 128 == 0
            for n, ch in VGG16_LAYOUT
            if ch is not None and n not in self._INT8_BF16_PREFIX[:-1])
        self.int8_bf16_prefix = self._INT8_BF16_PREFIX
        if int8_mode and int8_chain_from == "conv1_2":
            if self.int8_chain and max(int(64 * width), 8) == 64:
                self.int8_bf16_prefix = ("conv1_1",)
            else:
                warnings.warn("MODEL.INT8_CHAIN_FROM='conv1_2' has no effect: it needs "
                              "INT8_BACKEND='pallas', int8 widths that are multiples of 128 "
                              "and a 64-wide conv1; the int8 trunk starts at conv2_2",
                              stacklevel=2)
        self._int8_layers = None

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """``remat`` (``TRAIN.REMAT_TRUNK``): each conv (with its ReLU and the
        pool after it) runs under ``torch.utils.checkpoint``, so that only
        the layers' inputs are kept for the backward pass, each layer's
        activations recomputed there one layer at a time."""
        if self.int8_mode:
            self._int8_walk()
            refuse_grad("COMPUTE_DTYPE='int8' (the int8 trunk)", x, *self.parameters())
            return self.int8_body(self.int8_prefix(x))
        return self._float_forward(x, remat)

    def _layer(self, name: str, pool: bool, x: torch.Tensor, dt) -> torch.Tensor:
        x = F.relu(conv(getattr(self, name), x, dt))
        return F.max_pool2d(x, 2, 2) if pool else x

    @float32_precision()
    def _float_forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        dt = self.dtype or self.conv1_1.weight.dtype
        x = x.to(dt)
        layout = VGG16_LAYOUT
        if self.fuse_conv1 and x.shape[1] % 32 == 0 and x.shape[2] % 2 == 0:
            c1, c2 = self.conv1_1, self.conv1_2
            refuse_grad("MODEL.FUSE_CONV1 (the fused conv1 kernel)", x, *c1.parameters(),
                        *c2.parameters())
            x = fused_conv1_pool(x, c1.weight.to(dt), c1.bias.to(dt), c2.weight.to(dt),
                                 c2.bias.to(dt))
            layout = VGG16_LAYOUT[3:]  # conv1_1, conv1_2 and pool1 are done
        x = x.permute(0, 3, 1, 2)
        for i, (name, ch) in enumerate(layout):
            if ch is None:
                continue
            pool = i + 1 < len(layout) and layout[i + 1][1] is None
            if remat:
                x = checkpoint(self._layer, name, pool, x, dt, use_reentrant=False)
            else:
                x = self._layer(name, pool, x, dt)
        return x.permute(0, 2, 3, 1)

    # -- int8 path ---------------------------------------------------------

    def _int8_walk(self):
        """(conv names, {name: scale}, layout split after the bf16 prefix)."""
        conv_names = [n for n, ch in VGG16_LAYOUT if ch is not None]
        if len(self.int8_scales) < len(conv_names) - 1:
            raise ValueError(
                "int8 trunk needs MODEL.INT8_SCALES for conv1_1..conv5_2 "
                "(run aznet_tpu_torch.ops.quant.calibrate_trunk_int8 first); got "
                f"{len(self.int8_scales)} scales")
        split = [n for n, _ in VGG16_LAYOUT].index(self.int8_bf16_prefix[-1]) + 1
        return conv_names, dict(zip(conv_names, self.int8_scales)), split

    def prepare_int8(self) -> None:
        """Quantize the int8 layers' weights once, from their float32 values
        (call after loading weights; the trunk's parameters stay float32):
        the kernel's layout (:class:`Int8Conv`), or under ``'xla'`` the
        dy-major pack of ``quantize_weights`` with its scales and bias."""
        layers = {}
        for name, ch in VGG16_LAYOUT:
            if ch is None or name in self.int8_bf16_prefix:
                continue
            w, b = getattr(self, name).weight.detach(), getattr(self, name).bias.detach()
            layers[name] = ((*quantize_weights(w), b.float().contiguous())
                            if self.int8_backend == "xla" else Int8Conv.from_float(w, b))
        self._int8_layers = layers

    def int8_prefix(self, x: torch.Tensor) -> torch.Tensor:
        """Images ``[B, H, W, 3]`` -> int8 codes of the last bf16 prefix
        conv's output at its scale. Each conv multiplies bf16-rounded operands
        with f32 accumulation and adds the f32 bias before any rounding (TF32
        is exact on bf16 values, so it is allowed here)."""
        _, scales, split = self._int8_walk()
        last = self.int8_bf16_prefix[-1]
        x = x.to(torch.bfloat16)
        with float32_precision(tf32=True):
            for name, ch in VGG16_LAYOUT[:split]:
                if ch is None:
                    x = max_pool_2x2(x)
                    continue
                conv = getattr(self, name)
                y = F.conv2d(x.float().permute(0, 3, 1, 2),
                             conv.weight.detach().to(torch.bfloat16).float(), padding=1)
                y = torch.relu(y.permute(0, 2, 3, 1) + conv.bias.float())
                x = quantize_acts(y, scales[name]) if name == last else y.to(torch.bfloat16)
        return x

    def int8_body(self, x: torch.Tensor) -> torch.Tensor:
        """int8 codes from :meth:`int8_prefix` -> the trunk's bf16 output."""
        conv_names, scales, split = self._int8_walk()
        if self._int8_layers is None:
            raise RuntimeError("int8 weights are not quantized: call prepare_int8() "
                               "after loading the trunk's weights")
        s_x = scales[self.int8_bf16_prefix[-1]]
        entries = VGG16_LAYOUT[split:]
        i = 0
        while i < len(entries):
            name, ch = entries[i]
            i += 1
            if ch is None:  # a pool not fused into the conv before it
                x = max_pool_2x2(x)
                continue
            layer = self._int8_layers[name]
            # conv5_3 is the trunk's output: bf16, never requantized.
            s_out = None if name == conv_names[-1] else scales[name]
            if self.int8_backend == "xla":
                x = conv3x3_int8_dx(x, s_x, *layer, s_out)
            elif s_out is None:
                x = conv3x3_int8(x, s_x, layer, None, out_dtype=torch.bfloat16)
            else:
                fuse = (self.int8_chain and i < len(entries) and entries[i][1] is None
                        and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0)
                x = conv3x3_int8(x, s_x, layer, s_out, pool=fuse)
                i += fuse
            s_x = s_out
        return x
