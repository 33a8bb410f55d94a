"""VGG-16's conv1 block fused (``MODEL.FUSE_CONV1``): counterpart of
``aznet_tpu/ops/pallas/conv1_kernel.py::fused_conv1_pool``.

conv1_1 runs as a plain convolution in the input's dtype with no bias in
the conv, then ``+ b11`` in that dtype and ReLU (the reference's order, which
rounds twice in bf16). conv1_2, its f32 bias, ReLU and the 2x2/2 max-pool
then run as one step: the CUDA kernel (``ops/cuda/conv1_kernel.py``) for a
CUDA tensor, :func:`conv1_2_pool_reference` for a CPU tensor. Weights are the
trunk's own, OIHW; activations NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aznet_tpu_torch.ops.conv_int8 import max_pool_2x2
from aznet_tpu_torch.ops.cuda import conv1_kernel
from aznet_tpu_torch.utils.precision import float32_precision


def conv1_1_relu(x: torch.Tensor, w11: torch.Tensor, b11: torch.Tensor) -> torch.Tensor:
    """``relu(conv(x, w11) + b11)`` in ``x``'s dtype, NHWC in and out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w11.to(x.dtype), padding=1).permute(0, 2, 3, 1)
    return torch.relu(y + b11.to(x.dtype))


@float32_precision()
def conv1_2_pool_reference(y: torch.Tensor, w12: torch.Tensor, b12: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``y [B, H, W, C]`` -> ``[B, H/2,
    W/2, Co]`` in ``y``'s dtype. Nine f32 tap matmuls on the values of ``y``
    and ``w12`` (OIHW), summed in tap order, ``+ b12`` in f32, ReLU, the 2x2
    max-pool, one rounding to ``y``'s dtype."""
    b, h, w, c = y.shape
    yp = F.pad(y.float(), (0, 0, 1, 1, 1, 1))
    wf = w12.float()
    acc = None
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        d = yp[:, dy:dy + h, dx:dx + w] @ wf[:, :, dy, dx].t()
        acc = d if acc is None else acc + d
    return max_pool_2x2(torch.relu(acc + b12.float())).to(y.dtype)


def within_one_bf16_ulp(got: torch.Tensor, want: torch.Tensor):
    """The kernel's tolerance against its plain version: every element
    within one bf16 ulp of the larger of the two values, or within
    ``1e-5 * max|want|`` (values near zero after the ReLU). Returns (ok, the
    share of elements that differ)."""
    got, want = got.float(), want.float()
    _, exp = torch.frexp(torch.maximum(got.abs(), want.abs()))
    ulp = torch.ldexp(torch.ones_like(got), exp - 8)  # 2**(floor(log2|v|) - 7)
    floor = 1e-5 * want.abs().max()
    diff = (got - want).abs()
    ok = bool((diff <= torch.maximum(ulp, floor)).all())
    return ok, (diff > 0).float().mean().item()


def kernel_layout(w12: torch.Tensor) -> torch.Tensor:
    """OIHW ``[Co, C, 3, 3]`` -> the kernel's tiled bf16 ``[Cp/16, 9, 2, 64,
    8]``: 16-channel chunk, tap (dy*3 + dx), 8-channel half, output channel
    (zero-padded to 64, the wgmma M), channel; Cp is C rounded up to 16, the
    padding zeros. Each chunk's taps are the wgmma A operand's no-swizzle
    core matrices, and the whole tensor is one bulk copy."""
    co, c = w12.shape[:2]
    if co > 64 or c > 64:
        raise ValueError(f"the fused conv1 layout holds at most 64 channels, got {c}->{co}")
    cp = -(-c // 16) * 16
    w = F.pad(w12.to(torch.bfloat16), (0, 0, 0, 0, 0, cp - c, 0, 64 - co))  # [64, Cp, 3, 3]
    return w.reshape(64, cp // 16, 2, 8, 9).permute(1, 4, 2, 0, 3).contiguous()


def unpack_kernel_layout(w_k: torch.Tensor, c: int, co: int) -> torch.Tensor:
    """Inverse of :func:`kernel_layout`: the OIHW ``[Co, C, 3, 3]`` weights."""
    return w_k.permute(3, 0, 2, 4, 1).reshape(64, w_k.shape[0] * 16, 3, 3)[:co, :c]


def packed_weights(w12: torch.Tensor) -> torch.Tensor:
    """:func:`kernel_layout` of ``w12``, cached on the tensor and keyed on its
    storage and version counter, so an in-place update (``load_state_dict``,
    an optimizer step) or a new storage repacks it and a plain forward
    does not."""
    if w12.is_inference():  # no version counter to key on
        return kernel_layout(w12.detach())
    key = (w12.data_ptr(), w12._version, w12.dtype, tuple(w12.shape))
    cached = getattr(w12, "_conv1_kernel_layout", None)
    if cached is None or cached[0] != key:
        cached = (key, kernel_layout(w12.detach()))
        w12._conv1_kernel_layout = cached
    return cached[1]


def fused_conv1_pool(x: torch.Tensor, w11: torch.Tensor, b11: torch.Tensor,
                     w12: torch.Tensor, b12: torch.Tensor) -> torch.Tensor:
    """conv1_1 -> ReLU -> conv1_2 -> ReLU -> 2x2 max-pool: ``x [B, H, W, 3]``
    -> ``[B, H/2, W/2, C]`` in ``x``'s dtype. On the card the kernel takes bf16
    only, with C and Co multiples of 8 up to 64."""
    y = conv1_1_relu(x, w11, b11)
    if y.is_cuda:
        return conv1_kernel.conv1_2_pool_cuda(y.contiguous(), packed_weights(w12),
                                              b12.float().contiguous())
    if y.device.type != "cpu":
        raise ValueError(f"no fused conv1 for device {y.device}")
    return conv1_2_pool_reference(y, w12, b12)
