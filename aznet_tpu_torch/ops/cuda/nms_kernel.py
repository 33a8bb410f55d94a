"""Exact greedy NMS on the card: wrapper of ``aznet_tpu_torch/csrc/nms.cu``.

Replaces ``aznet_tpu/ops/pallas/nms_kernel.py::nms_pallas_batched`` (the
bitonic-order path). The kernel sorts each stream on the folded score key
(by counting: a row's position is the number of rows with a smaller key,
spread over the card), builds the 64-bit suppression bitmask over the
upper-triangle 64x64 tiles only, and runs the greedy scan over 64-row word
blocks from a shared-memory ring filled by one bulk copy a block, each
block resolved by warp ballots, writing keep flags straight to original
slots. Above :data:`SMEM_MAX_N` boxes a second route of the same source
takes over (the sort over chunks of keys, the scan reading the kept rows
from global memory without the ring), up to :data:`MAX_N`. What bounds it:
the N^2/2 IoUs of the mask pass and the scan's serial chain of N/64 word
blocks per stream (see the source's header).

Only CUDA tensors are accepted; the plain PyTorch version of the same
function is :func:`aznet_tpu_torch.ops.nms.nms_mask_reference`, and the
dispatch between them is :func:`aznet_tpu_torch.ops.nms.nms_mask_batched`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

SMEM_MAX_N = 8192  # the largest sort width of the shared-memory route
MAX_N = 65536  # the large route's
SORT_CHUNK = 8192  # keys a chunk of the large route's sort (kChunk in the source)
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
                       ctypes.c_float, ctypes.c_float, p, ctypes.c_size_t, p, p]
        fn.restype = ctypes.c_int
        lib.aznet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.aznet_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.aznet_cuda_error_string)
    return _fn


def sort_width(n: int) -> int:
    """The padded sort width of N boxes: a power of two, at least 64."""
    return max(TILE, 1 << (n - 1).bit_length())


def scratch_bytes(bsz: int, n_pad: int) -> int:
    """Bytes of the kernel's one scratch buffer (``Scratch`` in the source):
    the mask ``[B, n_pad, n_pad / 64]`` u64, the sorted boxes ``[B, n_pad, 4]``
    f32 and the sorted indices ``[B, n_pad]`` i32."""
    return bsz * n_pad * (n_pad // 8 + 16 + 4)


def triangle_tile(blk):
    """The mask pass's block ``blk`` -> its tile ``(row tile, column tile)``,
    row <= column, as the kernel inverts ``blk = col * (col + 1) / 2 + row``
    (a float32 square root, then corrected). ``blk`` is an int or an array
    of them (then both are arrays)."""
    b = np.asarray(blk, np.int64)
    c = ((np.sqrt(np.float32(8.0) * b.astype(np.float32) + np.float32(1.0)) - np.float32(1.0))
         * np.float32(0.5)).astype(np.int64)
    while (over := c * (c + 1) // 2 > b).any():
        c = c - over
    while (under := (c + 1) * (c + 2) // 2 <= b).any():
        c = c + under
    row = b - c * (c + 1) // 2
    return (int(row), int(c)) if b.ndim == 0 else (row, c)


def nms_cuda_batched(boxes: torch.Tensor, scores: torch.Tensor,
                     thresh: float, valid: torch.Tensor,
                     offset: float = 1.0) -> torch.Tensor:
    """Keep masks ``[B, N]`` bool, in original order, for ``boxes [B, N, 4]``
    f32, ``scores [B, N]`` f32 and ``valid [B, N]`` bool, all contiguous on
    one CUDA device. Raises on anything else, for N > :data:`MAX_N`, and
    (``torch.cuda.OutOfMemoryError``, naming the bytes) where the scratch
    does not fit on the card."""
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
    n_pad = sort_width(n)
    nbytes = scratch_bytes(bsz, n_pad)
    try:
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    except torch.cuda.OutOfMemoryError as e:
        raise torch.cuda.OutOfMemoryError(
            f"NMS of {bsz} x {n} boxes needs {nbytes} bytes of scratch "
            f"({bsz} x {n_pad} x ({n_pad} / 8 + 20)), which do not fit on {dev}") from e
    fn, err_str = _launcher()
    idx = dev.index
    args = (boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), bsz, n, n_pad,
            float(thresh), float(offset), scratch.data_ptr(), nbytes, keep.data_ptr(),
            torch._C._cuda_getCurrentRawStream(idx))
    if idx == torch.cuda.current_device():
        err = fn(*args)
    else:  # the launches go to the current device's context
        with torch.cuda.device(idx):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: {err_str(err).decode()} ({err})")
    LAUNCHES += 1
    return keep
