"""Frozen BatchNorm's epilogue after a ResNet convolution: the per-channel
affine ``y * s + b`` (``models/resnet.py::FrozenBN``), an optional residual
(the block input, or the downsample's output through its own affine), and
the ReLU.

For a CUDA tensor while autograd does not record, one launch of the kernel
(``ops/cuda/frozen_bn_kernel.py``), which writes the result into ``y``; for
a CPU tensor, or while autograd records (the ResNet train step), the plain
version, PyTorch's separate operations, so that the gradients are PyTorch's
own. The two agree bit for bit: the kernel rounds after each step as the
separate operations do (twice in bf16 for the affine, as the reference
does).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aznet_tpu_torch.ops.cuda import frozen_bn_kernel


def frozen_bn_relu_reference(y: torch.Tensor, s: torch.Tensor, b: torch.Tensor,
                             r: torch.Tensor | None = None, sr: torch.Tensor | None = None,
                             br: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``relu(y * s + b)`` on NCHW
    ``y`` with ``s``, ``b`` ``[C]`` in ``y``'s dtype; with ``r`` (``y``'s
    shape), ``relu((y * s + b) + r)``, and with ``sr``, ``br`` as well,
    ``relu((y * s + b) + (r * sr + br))``."""
    out = y * s[:, None, None] + b[:, None, None]
    if r is not None:
        if sr is not None:
            r = r * sr[:, None, None] + br[:, None, None]
        out = out + r
    return F.relu(out)


def frozen_bn_relu(y: torch.Tensor, s: torch.Tensor, b: torch.Tensor,
                   r: torch.Tensor | None = None, sr: torch.Tensor | None = None,
                   br: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`frozen_bn_relu_reference`'s function. On the card, with no
    autograd recording, the kernel computes it into ``y`` (a convolution's
    output that nothing else holds), which it returns; the kernel raises on
    what it does not take (not channels-last, a dtype other than bf16 or
    float32, C not a multiple of 8)."""
    if y.is_cuda and not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (y, s, b, r, sr, br))):
        return frozen_bn_kernel.frozen_bn_relu_cuda(y, s, b, r, sr, br)
    return frozen_bn_relu_reference(y, s, b, r, sr, br)
