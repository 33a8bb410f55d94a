"""Exact greedy NMS on the card: wrapper of ``aznet_tpu_torch/csrc/nms.cu``.

Replaces ``aznet_tpu/ops/pallas/nms_kernel.py::nms_pallas_batched`` (the
bitonic-order path). The kernel sorts each stream on the folded score key
in shared memory, builds the 64-bit suppression bitmask over upper-triangle
64x64 tiles, and runs the sequential greedy scan, writing keep flags straight
to original slots. What bounds it: the O(N^2/64) mask words it writes and the
N-step serial scan per stream (see the source's header).

Only CUDA tensors are accepted; the plain PyTorch version of the same
function is :func:`aznet_tpu_torch.ops.nms.nms_mask_reference`, and the
dispatch between them is :func:`aznet_tpu_torch.ops.nms.nms_mask_batched`.
"""

from __future__ import annotations

import ctypes

import torch

MAX_N = 8192
TILE = 64

# Launches of the kernel sequence (one per call that reaches the card).
LAUNCHES = 0

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        from aznet_tpu_torch import _build

        lib = _build.load()
        fn = lib.aznet_nms_launch
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.aznet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.aznet_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.aznet_cuda_error_string)
    return _fn


def nms_cuda_batched(boxes: torch.Tensor, scores: torch.Tensor,
                     thresh: float, valid: torch.Tensor,
                     offset: float = 1.0) -> torch.Tensor:
    """Keep masks ``[B, N]`` bool, in original order, for ``boxes [B, N, 4]``
    f32, ``scores [B, N]`` f32 and ``valid [B, N]`` bool, all contiguous on
    one CUDA device. Raises on anything else, and for N > 8192."""
    global LAUNCHES
    if not (boxes.is_cuda and scores.is_cuda and valid.is_cuda):
        raise ValueError("nms_cuda_batched takes CUDA tensors only")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"boxes/scores must be float32, got {boxes.dtype}/{scores.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if boxes.ndim != 3 or boxes.shape[2] != 4 or scores.shape != boxes.shape[:2] \
            or valid.shape != scores.shape:
        raise ValueError(f"shapes boxes {tuple(boxes.shape)}, scores "
                         f"{tuple(scores.shape)}, valid {tuple(valid.shape)}")
    if not (boxes.is_contiguous() and scores.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_cuda_batched needs contiguous tensors")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (rows are read as float4)")
    bsz, n = scores.shape
    if n > MAX_N:
        raise ValueError(f"nms_cuda_batched supports N <= {MAX_N}, got {n}")
    if bsz > 65535:
        raise ValueError(f"nms_cuda_batched supports B <= 65535, got {bsz}")
    dev = boxes.device
    keep = torch.empty((bsz, n), dtype=torch.bool, device=dev)
    if bsz == 0 or n == 0:
        return keep
    n_pad = max(TILE, 1 << (n - 1).bit_length())  # sort width: a power of two
    sorted_idx = torch.empty((bsz, n_pad), dtype=torch.int32, device=dev)
    sorted_boxes = torch.empty((bsz, n_pad, 4), dtype=torch.float32, device=dev)
    sorted_valid = torch.empty((bsz, n_pad), dtype=torch.uint8, device=dev)
    mask = torch.empty((bsz, n_pad, n_pad // TILE), dtype=torch.int64, device=dev)
    fn, err_str = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), bsz, n,
                 n_pad, float(thresh), float(offset), sorted_idx.data_ptr(),
                 sorted_boxes.data_ptr(), sorted_valid.data_ptr(),
                 mask.data_ptr(), keep.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: {err_str(err).decode()} ({err})")
    LAUNCHES += 1
    return keep
