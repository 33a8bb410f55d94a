"""Tiled IoU matrix on the card: wrapper of ``aznet_tpu_torch/csrc/iou.cu``.

Replaces ``aznet_tpu/ops/pallas/iou_kernel.py::bbox_overlaps_pallas``. Like
that kernel, nothing on a main path calls it: the search's NMS computes its
IoUs inside its own kernel, and the plain ``ops/iou.py::bbox_overlaps``
stays the function the plain NMS uses. One block per tile of 32 x 128 box
pairs; it is bound by the bytes of the output it writes.

Only CUDA tensors are accepted; the plain PyTorch version is
``aznet_tpu_torch.ops.iou.bbox_overlaps``, equal bit for bit on finite
boxes.
"""

from __future__ import annotations

import ctypes

import torch

MAX_ROWS = 65535 * 32  # the grid's second dimension times the rows of a tile

# Launches of the kernel (one per call that reaches the card).
LAUNCHES = 0

_fns = None


def _launcher():
    global _fns
    if _fns is None:
        from aznet_tpu_torch import _build

        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.aznet_iou_launch
        fn.argtypes = [p, p, i, i, ctypes.c_float, p, p]
        fn.restype = i
        lib.aznet_cuda_error_string.argtypes = [i]
        lib.aznet_cuda_error_string.restype = ctypes.c_char_p
        _fns = (fn, lib.aznet_cuda_error_string)
    return _fns


def bbox_overlaps_cuda(boxes: torch.Tensor, query_boxes: torch.Tensor,
                       offset: float = 1.0) -> torch.Tensor:
    """IoU of ``boxes [N, 4]`` against ``query_boxes [K, 4]`` -> float32
    ``[N, K]``, ``+offset`` areas, 0 where the union is <= 0. Float boxes on
    one CUDA device, cast to float32 as the reference casts them; raises on
    anything else."""
    global LAUNCHES
    if not (boxes.is_cuda and query_boxes.is_cuda) or boxes.device != query_boxes.device:
        raise ValueError("bbox_overlaps_cuda takes CUDA tensors on one device")
    if not (boxes.is_floating_point() and query_boxes.is_floating_point()):
        raise TypeError(f"boxes must be float, got {boxes.dtype} and {query_boxes.dtype}")
    if boxes.ndim != 2 or query_boxes.ndim != 2 or boxes.shape[1] != 4 or query_boxes.shape[1] != 4:
        raise ValueError(f"shapes {tuple(boxes.shape)} and {tuple(query_boxes.shape)}, "
                         f"expected [N, 4] and [K, 4]")
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n > MAX_ROWS:
        raise ValueError(f"N <= {MAX_ROWS}, got {n}")
    boxes = boxes.to(torch.float32).contiguous()
    query_boxes = query_boxes.to(torch.float32).contiguous()
    out = torch.empty((n, k), dtype=torch.float32, device=boxes.device)
    if n == 0 or k == 0:
        return out
    fn, err_str = _launcher()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = fn(boxes.data_ptr(), query_boxes.data_ptr(), n, k, float(offset),
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"IoU kernel launch failed: {err_str(err).decode()} ({err})")
    LAUNCHES += 1
    return out
