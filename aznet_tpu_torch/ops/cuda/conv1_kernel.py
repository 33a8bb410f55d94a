"""Fused conv1_2 + ReLU + pool1 on the card: wrapper of
``aznet_tpu_torch/csrc/conv1_fused.cu``.

Replaces ``aznet_tpu/ops/pallas/conv1_kernel.py::fused_conv1_pool`` (its
Pallas part; conv1_1 runs outside, as there). An implicit GEMM on the bf16
tensor cores (``mma.sync`` m16n8k16, f32 accumulation) over tiles of 2 rows
x 64 columns x 64 output channels, with bias, ReLU and the 2x2/2 max-pool in
the epilogue (see the source's header). Bound by compute at VGG-16's shape.

Only CUDA tensors are accepted; the plain PyTorch version is
``aznet_tpu_torch.ops.conv1_fused.conv1_2_pool_reference`` and the dispatch
is ``aznet_tpu_torch.ops.conv1_fused.fused_conv1_pool``.
"""

from __future__ import annotations

import ctypes

import torch

CHANNEL_MULTIPLE = 16  # the kernel's K chunk and N step

# Launches of the kernel (one per call that reaches the card).
LAUNCHES = 0

_fns = None


def _launcher():
    global _fns
    if _fns is None:
        from aznet_tpu_torch import _build

        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.aznet_conv1_fused
        fn.argtypes = [p, p, p, i, i, i, i, i, p, p]
        fn.restype = i
        lib.aznet_cuda_error_string.argtypes = [i]
        lib.aznet_cuda_error_string.restype = ctypes.c_char_p
        _fns = (fn, lib.aznet_cuda_error_string)
    return _fns


def conv1_2_pool_cuda(y: torch.Tensor, w9: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``y [B, H, W, C]`` bf16 (H, W even), ``w9 [9, Co, C]`` bf16 (tap =
    dy*3 + dx), ``bias [Co]`` f32, contiguous on one CUDA device -> bf16
    ``[B, H/2, W/2, Co]``: 3x3 SAME conv, + bias, ReLU, 2x2/2 max-pool. C and
    Co must be multiples of 16. Raises on anything else."""
    global LAUNCHES
    tensors = (y, w9, bias)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("conv1_2_pool_cuda takes CUDA tensors on one device")
    if y.dtype != torch.bfloat16 or w9.dtype != torch.bfloat16:
        raise TypeError(f"the fused conv1 kernel takes bf16 y and w9, got {y.dtype}/{w9.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    if y.ndim != 4 or w9.ndim != 3 or w9.shape[0] != 9 or w9.shape[2] != y.shape[3]:
        raise ValueError(f"shapes y {tuple(y.shape)}, w9 {tuple(w9.shape)}")
    b, h, w, c = y.shape
    co = w9.shape[1]
    if c % CHANNEL_MULTIPLE or co % CHANNEL_MULTIPLE:
        raise ValueError(f"the fused conv1 kernel takes C and Co that are multiples of "
                         f"{CHANNEL_MULTIPLE}, got {c}, {co}")
    if h % 2 or w % 2:
        raise ValueError(f"the fused 2x2 pool needs even H and W, got {h}x{w}")
    if bias.shape != (co,):
        raise ValueError(f"bias {tuple(bias.shape)} vs Co={co}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the fused conv1 kernel needs contiguous tensors")
    if y.data_ptr() % 8 or w9.data_ptr() % 16:
        raise ValueError("y must be 8-byte and w9 16-byte aligned")
    if h // 2 > 65535 or b * -(-co // 64) > 65535:
        raise ValueError(f"grid too large for y {tuple(y.shape)}, Co={co}")
    out = torch.empty((b, h // 2, w // 2, co), dtype=torch.bfloat16, device=y.device)
    fn, err_str = _launcher()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), w9.data_ptr(), bias.data_ptr(), b, h, w, c, co,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused conv1 kernel launch failed: {err_str(err).decode()} ({err})")
    LAUNCHES += 1
    return out
