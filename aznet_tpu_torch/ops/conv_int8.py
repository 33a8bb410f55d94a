"""Int8 convolution: quantization, weight packing, the 3x3 conv's plain
PyTorch version and its dispatch to the CUDA kernel, and the 1x1 conv of the
ResNet bottlenecks (counterpart of ``aznet_tpu/ops/conv_int8.py`` plus the
host side of ``aznet_tpu/ops/pallas/conv_int8_chain.py`` and
``conv_int8_kernel.py``).

Scheme (as the reference): symmetric, zero-point 0; weights per output
channel, ``s_w = max(max|w| / 127, 1e-12)``; activations one static scale per
layer from calibration (``ops/quant.py``). A layer computes

    acc = sum over the 9 taps of x_int8 . w_int8          (int32, exact)
    y   = relu(float(acc) * (f32(s_x) * s_w) + bias)      (f32, mul then add)
    [2x2/2 max-pool of y]                                  (exact: requant is monotone)
    out = clip(round(y * f32(1 / s_out)), -127, 127)       (int8, half to even)
          or y rounded to bf16 at the trunk's exit.

Activations are compact NHWC int8 between layers; the reference's haloed
layout and row strips are TPU alignment devices and have no counterpart.

:func:`conv3x3_int8` dispatches on the device only: a CUDA tensor launches
the kernel (``ops/cuda/conv_int8_kernel.py``) and a CPU tensor takes
:func:`conv3x3_int8_reference`. Nothing falls back.

:func:`conv3x3_int8_dx` is the reference's portable form
(``INT8_BACKEND='xla'``): three dx-packed int8 GEMMs through
:func:`int8_matmul`, the same code on the CPU and on the card, and
requantization by a true division (:func:`quantize_acts`) where the kernel
multiplies by the reciprocal.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from aznet_tpu_torch.ops.cuda import conv_int8_kernel

INT8_MAX = 127.0
EXACT_C = 1040  # int8 products a float32 sum holds exactly: 127**2 * 1040 < 2**24


def scalar_f32(value: float, device) -> torch.Tensor:
    """A 0-dim float32 tensor ON ``device``: ``x / python_float`` on a CUDA
    tensor is computed as ``x * (1 / s)``, which is not the reference's
    division; a device tensor keeps it a true division."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def quantize_acts(x: torch.Tensor, scale: float) -> torch.Tensor:
    """float -> int8 at a static scale: ``clip(round(x / scale), +-127)``,
    round half to even, a true float32 division."""
    q = torch.round(x.float() / scalar_f32(scale, x.device))
    return q.clamp_(-INT8_MAX, INT8_MAX).to(torch.int8)


def pack_weights_9(w: torch.Tensor):
    """OIHW float ``[Co, C, 3, 3]`` -> (int8 ``[9, C, Co]`` in (dy*3 + dx)
    order, scales ``[Co]`` f32), quantized per output channel from the
    float32 values (``conv_int8_kernel.pack_weights_9``)."""
    w = w.float().permute(2, 3, 1, 0)  # [3, 3, C, Co], the reference's HWIO
    s = torch.clamp(w.abs().amax(dim=(0, 1, 2)) / scalar_f32(INT8_MAX, w.device), min=1e-12)
    q = torch.round(w / s).clamp_(-INT8_MAX, INT8_MAX).to(torch.int8)
    return q.reshape(9, w.shape[2], w.shape[3]), s


def quantize_weights(w: torch.Tensor):
    """OIHW float ``[Co, C, 3, 3]`` -> (int8 ``[3, 3C, Co]``, scales ``[Co]``
    f32): the reference's dy-major pack for :func:`conv3x3_int8_dx`, row
    ``dx * C + c`` of slab ``dy`` (the channel order of :func:`dx_pack`),
    quantized per output channel from the float32 values. Each slab is
    stored column-major (``w_q[dy].t()`` is a contiguous ``[Co, 3C]``): the
    card's int8 GEMM takes its second operand so at every shape, and refuses
    some shapes of a row-major one."""
    q9, s = pack_weights_9(w)
    q = q9.reshape(3, 3 * q9.shape[1], q9.shape[2])
    return q.transpose(1, 2).contiguous().transpose(1, 2), s


def dx_pack(xp: torch.Tensor) -> torch.Tensor:
    """Zero-padded ``[B, H+2, W+2, C]`` -> ``[B, H+2, W, 3C]``: the three
    dx-shifted copies side by side along the channels."""
    w = xp.shape[2] - 2
    return torch.cat([xp[:, :, 0:w], xp[:, :, 1:w + 1], xp[:, :, 2:w + 2]], dim=-1)


# torch._int_mm on CUDA takes more than 16 rows; the search's first level has 8.
INT_MM_MIN_ROWS = 32


def int8_matmul(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """``x8 [M, K] @ w8[N, K].T`` in exact int32. ``torch._int_mm`` (the
    card's int8 GEMM; also exact on the CPU); rows are zero-padded to at
    least :data:`INT_MM_MIN_ROWS` on the card."""
    m = x8.shape[0]
    if x8.is_cuda and m < INT_MM_MIN_ROWS:
        x8 = F.pad(x8, (0, 0, 0, INT_MM_MIN_ROWS - m))
    return torch._int_mm(x8, w8.t())[:m]


def quantize_columns(w: torch.Tensor):
    """Linear weight ``[out, in]`` -> (int8 ``[out, in]``, scales ``[out]``):
    one scale per output column of the reference's ``[in, out]`` kernel
    (``_FCStack._int8_stack``), from the float32 values of ``w``."""
    w = w.float()
    s = torch.clamp(w.abs().amax(dim=1) / scalar_f32(INT8_MAX, w.device), min=1e-12)
    return torch.round(w / s[:, None]).clamp_(-INT8_MAX, INT8_MAX).to(torch.int8), s


@dataclasses.dataclass
class Int8Conv:
    """One quantized 3x3 layer: ``w_k`` int8 in the kernel's tiled layout
    (:func:`kernel_layout`), ``s_w`` and ``bias`` ``[Co]`` float32."""

    w_k: torch.Tensor
    s_w: torch.Tensor
    bias: torch.Tensor

    @classmethod
    def from_float(cls, weight: torch.Tensor, bias: torch.Tensor) -> "Int8Conv":
        """Quantize an OIHW float weight (float32 values) and its bias."""
        w_q9, s_w = pack_weights_9(weight)
        return cls(kernel_layout(w_q9), s_w, bias.float().contiguous())


def kernel_layout(w_q9: torch.Tensor) -> torch.Tensor:
    """``[9, C, Co]`` (:func:`pack_weights_9`) -> the kernel's tiled layout
    ``[Co/128, Cp/32, 2, 9, 128, 16]`` int8: for each block of 128 output
    channels and each chunk of 32 input channels, one contiguous 36,864-byte
    piece in the order the kernel stages it (16-channel half, tap, output
    channel, 16 channels), so that one bulk copy moves it. C is zero-padded
    to Cp (a multiple of 32) and Co to a multiple of 128."""
    _, c, co = w_q9.shape
    kc, nt = conv_int8_kernel.K_CHUNK, conv_int8_kernel.CO_TILE
    cp, cop = -(-c // kc) * kc, -(-co // nt) * nt
    w = F.pad(w_q9, (0, cop - co, 0, cp - c))  # [9, Cp, Cop]
    w = w.reshape(9, cp // kc, 2, kc // 2, cop // nt, nt)  # tap, chunk, half, ch, tile, n
    return w.permute(4, 1, 2, 0, 5, 3).contiguous()


def unpack_kernel_layout(w_k: torch.Tensor, c: int, co: int) -> torch.Tensor:
    """The inverse of :func:`kernel_layout`: ``[9, C, Co]``."""
    tiles, chunks = w_k.shape[:2]
    w = w_k.permute(3, 1, 2, 5, 0, 4).reshape(9, chunks * conv_int8_kernel.K_CHUNK,
                                               tiles * conv_int8_kernel.CO_TILE)
    return w[:, :c, :co]


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max-pool of NHWC ``x`` with floor semantics (``nn.max_pool``
    VALID: a trailing odd row/column is dropped); any dtype."""
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def conv3x3_int8_reference(x: torch.Tensor, s_x: float, layer: Int8Conv,
                           s_out: float | None = None, pool: bool = False,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the kernel. ``x [B, H, W, C]`` int8 at scale
    ``s_x`` -> int8 ``[B, H', W', Co]`` at ``s_out`` (H', W' halved when
    ``pool``), or ``out_dtype`` when ``s_out`` is None.

    The int32 sum is exact: each tap is float32 products of int8 values
    over at most :data:`EXACT_C` channels at a time, whose partial sums stay
    below ``127**2 * 1040 < 2**24`` (int8 values are exact in TF32 too),
    converted to int32; the taps and channel chunks are summed in int32."""
    b, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = unpack_kernel_layout(layer.w_k, c, layer.s_w.shape[0]).float()  # [9, C, Co]
    acc = None
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        for c0 in range(0, c, EXACT_C):
            d = (xp[:, dy:dy + h, dx:dx + w, c0:c0 + EXACT_C] @ wf[tap, c0:c0 + EXACT_C]
                 ).to(torch.int32)
            acc = d if acc is None else acc + d
    y = acc.float() * (scalar_f32(s_x, x.device) * layer.s_w) + layer.bias
    y = torch.relu(y)
    if pool:
        y = max_pool_2x2(y)
    if s_out is None:
        return y.to(out_dtype)
    q = torch.round(y * scalar_f32(1.0 / s_out, x.device))
    return q.clamp_(-INT8_MAX, INT8_MAX).to(torch.int8)


def conv3x3_int8_dx(x8: torch.Tensor, s_x: float, w_q: torch.Tensor, s_w: torch.Tensor,
                    bias: torch.Tensor, s_out: float | None = None,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """3x3/SAME conv + ReLU on int8 NHWC ``x8`` at scale ``s_x`` as three
    dx-packed GEMMs (``aznet_tpu/ops/conv_int8.py::conv3x3_int8``), with
    ``(w_q [3, 3C, Co], s_w)`` from :func:`quantize_weights` and ``bias [Co]``
    f32: for each dy, rows dy..dy+H of :func:`dx_pack` of the padded input
    times ``w_q[dy]`` (K = 3C) in exact int32, summed in dy order; then
    ``float(acc) * (f32(s_x) * s_w)``, ``+ bias`` (two roundings), ReLU.
    Returns int8 codes at ``s_out`` (:func:`quantize_acts`, a true
    division) or ``out_dtype`` when ``s_out`` is None. On the card
    ``_int_mm`` needs C and Co multiples of 8 (K = 3C)."""
    b, h, w, c = x8.shape
    if x8.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"conv3x3_int8_dx takes int8 operands, got {x8.dtype} and {w_q.dtype}")
    if w_q.shape[:2] != (3, 3 * c):
        raise ValueError(f"weights {tuple(w_q.shape)} for {c} input channels")
    if x8.is_cuda and (c % 8 or w_q.shape[2] % 8):
        raise ValueError(f"the card's int8 GEMM takes C and Co multiples of 8, got "
                         f"{c} -> {w_q.shape[2]}")
    xc = dx_pack(F.pad(x8, (0, 0, 1, 1, 1, 1)))
    acc = None
    for dy in range(3):
        d = int8_matmul(xc[:, dy:dy + h].reshape(-1, 3 * c), w_q[dy].t().contiguous())
        acc = d if acc is None else acc + d
    y = acc.float() * (scalar_f32(s_x, x8.device) * s_w) + bias
    y = torch.relu(y).reshape(b, h, w, -1)
    return y.to(out_dtype) if s_out is None else quantize_acts(y, s_out)


def quantize_weights_1x1(w: torch.Tensor):
    """1x1 conv weight, OIHW ``[Co, C, 1, 1]`` (or ``[Co, C]``) -> (int8
    ``[Co, C]``, scales ``[Co]`` f32), per output channel from the float32
    values (the reference's ``quantize_weights_1x1``, which returns the
    transpose ``[C, Co]``)."""
    return quantize_columns(w.reshape(w.shape[0], w.shape[1]))


def conv1x1_int8(x8: torch.Tensor, s_x: float, w_q: torch.Tensor, s_w: torch.Tensor,
                 out_dtype=torch.float32) -> torch.Tensor:
    """1x1 conv on int8 activations ``x8 [..., C]`` at scale ``s_x``, with
    ``(w_q [Co, C], s_w)`` from :func:`quantize_weights_1x1`: one int8 GEMM
    with exact int32 sums (``models/heads.py::int8_matmul``, ``torch._int_mm``),
    then ``float(acc) * (f32(s_x) * s_w)`` in float32, then ``out_dtype``. On
    the card, ``_int_mm`` needs C and Co multiples of 8: other widths raise
    (no float fallback)."""
    c = x8.shape[-1]
    if x8.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"conv1x1_int8 takes int8 operands, got {x8.dtype} and {w_q.dtype}")
    if w_q.shape[1] != c:
        raise ValueError(f"weights {tuple(w_q.shape)} for {c} input channels")
    if x8.is_cuda and (c % 8 or w_q.shape[0] % 8):
        raise ValueError(f"the card's int8 GEMM takes C and Co multiples of 8, got "
                         f"{c} -> {w_q.shape[0]}")
    acc = int8_matmul(x8.reshape(-1, c), w_q)
    y = acc.float() * (scalar_f32(s_x, x8.device) * s_w)
    return y.to(out_dtype).reshape(*x8.shape[:-1], w_q.shape[0])


def conv3x3_int8(x: torch.Tensor, s_x: float, layer: Int8Conv,
                 s_out: float | None = None, pool: bool = False,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """3x3/SAME conv + ReLU (+ fused 2x2 max-pool) on int8 NHWC activations:
    the CUDA kernel for a CUDA tensor (the chain entry when ``pool``, else
    the strip entry), the plain version for a CPU tensor."""
    if x.is_cuda:
        if pool:
            return conv_int8_kernel.conv3x3_int8_chain(
                x, s_x, layer.w_k, layer.s_w, layer.bias, s_out)
        return conv_int8_kernel.conv3x3_int8_strip(
            x, s_x, layer.w_k, layer.s_w, layer.bias, s_out, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"no int8 conv for device {x.device}")
    return conv3x3_int8_reference(x, s_x, layer, s_out, pool, out_dtype)
