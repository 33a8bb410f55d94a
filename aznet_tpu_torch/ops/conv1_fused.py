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


def conv1_1_relu(x: torch.Tensor, w11: torch.Tensor, b11: torch.Tensor) -> torch.Tensor:
    """``relu(conv(x, w11) + b11)`` in ``x``'s dtype, NHWC in and out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w11.to(x.dtype), padding=1).permute(0, 2, 3, 1)
    return torch.relu(y + b11.to(x.dtype))


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


def kernel_weights(w12: torch.Tensor) -> torch.Tensor:
    """OIHW ``[Co, C, 3, 3]`` -> the kernel's bf16 ``[9, Co, C]`` (tap = dy*3
    + dx, input channels contiguous)."""
    co, c = w12.shape[:2]
    return w12.permute(2, 3, 0, 1).reshape(9, co, c).to(torch.bfloat16).contiguous()


def fused_conv1_pool(x: torch.Tensor, w11: torch.Tensor, b11: torch.Tensor,
                     w12: torch.Tensor, b12: torch.Tensor) -> torch.Tensor:
    """conv1_1 -> ReLU -> conv1_2 -> ReLU -> 2x2 max-pool: ``x [B, H, W, 3]``
    -> ``[B, H/2, W/2, C]`` in ``x``'s dtype. On the card the kernel takes bf16
    only, with C a multiple of 16."""
    y = conv1_1_relu(x, w11, b11)
    if y.is_cuda:
        return conv1_kernel.conv1_2_pool_cuda(y.contiguous(), kernel_weights(w12),
                                              b12.float().contiguous())
    if y.device.type != "cpu":
        raise ValueError(f"no fused conv1 for device {y.device}")
    return conv1_2_pool_reference(y, w12, b12)
