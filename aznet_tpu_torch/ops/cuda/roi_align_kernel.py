"""Fused ROI align on the card: wrapper of ``aznet_tpu_torch/csrc/roi_align.cu``.

Replaces ``aznet_tpu/ops/pallas/roi_kernel.py`` (``roi_align_pallas`` and
its two large-map tilings, ``roi_align_pallas_big`` and ``_big_v2``): one
kernel with an H-first / W-first flag. One block per (roi, 128-channel
tile, bin of the first axis), one thread per channel; the first contraction
goes to shared memory for the cells the second one reads, then the second
contraction. It is bound by latency: at most 4 x 4 taps per output value,
no tensor cores.

Only CUDA tensors are accepted; the plain PyTorch version is
``aznet_tpu_torch.ops.roi_pool.roi_align_fused_reference`` and the dispatch
is ``aznet_tpu_torch.ops.roi_pool.roi_align_fused``.
"""

from __future__ import annotations

import ctypes

import torch

MAX_POOL = 16  # the kernel's shared tap tables hold up to 16 bins per axis

# Launches of the kernel (one per call that reaches the card).
LAUNCHES = 0

_fns = None


def _launcher():
    global _fns
    if _fns is None:
        from aznet_tpu_torch import _build

        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.aznet_roi_align
        fn.argtypes = [p, p, i, i, i, i, ctypes.c_float, i, i, i, p, p]
        fn.restype = i
        lib.aznet_cuda_error_string.argtypes = [i]
        lib.aznet_cuda_error_string.restype = ctypes.c_char_p
        _fns = (fn, lib.aznet_cuda_error_string)
    return _fns


def roi_align_cuda(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
                   pool_size: int, w_first: bool) -> torch.Tensor:
    """``feat [H, W, C]`` bf16/f32 and ``rois [R, 4]`` f32, contiguous on one
    CUDA device -> ``[R, P, P, C]`` in ``feat``'s dtype. Raises on anything
    else."""
    global LAUNCHES
    if not (feat.is_cuda and rois.is_cuda) or feat.device != rois.device:
        raise ValueError("roi_align_cuda takes CUDA tensors on one device")
    if feat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"roi_align_cuda takes bf16 or f32 features, got {feat.dtype}")
    if rois.dtype != torch.float32:
        raise TypeError(f"rois must be float32, got {rois.dtype}")
    if feat.ndim != 3 or rois.ndim != 2 or rois.shape[1] != 4:
        raise ValueError(f"shapes feat {tuple(feat.shape)}, rois {tuple(rois.shape)}")
    if not 1 <= pool_size <= MAX_POOL:
        raise ValueError(f"pool_size must be in [1, {MAX_POOL}], got {pool_size}")
    feat, rois = feat.contiguous(), rois.contiguous()
    h, w, c = feat.shape
    r = rois.shape[0]
    out = torch.empty((r, pool_size, pool_size, c), dtype=feat.dtype, device=feat.device)
    if r == 0 or c == 0:
        return out
    fn, err_str = _launcher()
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = fn(feat.data_ptr(), rois.data_ptr(), r, h, w, c, float(spatial_scale),
                 pool_size, int(w_first), int(feat.dtype == torch.bfloat16),
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ROI-align kernel launch failed: {err_str(err).decode()} ({err})")
    LAUNCHES += 1
    return out
