"""Tiled IoU matrix on the card: wrapper of ``aznet_tpu_torch/csrc/iou.cu``.

Replaces ``aznet_tpu/ops/pallas/iou_kernel.py::bbox_overlaps_pallas``. Like
that kernel, nothing on a main path calls it: the search's NMS computes its
IoUs inside its own kernel, and the plain ``ops/iou.py::bbox_overlaps``
stays the function the plain NMS uses. Persistent warps, each walking an
even share of the (128-column tile, row) slices of the matrix, or one warp
a slice when they are few (4 columns a lane in registers, 16-byte stores
when K % 4 == 0); it is bound by the bytes of the output it writes. N and
K have no cap.

Only CUDA tensors are accepted; the plain PyTorch version is
``aznet_tpu_torch.ops.iou.bbox_overlaps``, equal bit for bit on finite
boxes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from aznet_tpu_torch.ops.cuda import sm_count

LANES = 32
PER_LANE = 4  # column boxes a lane keeps in registers
TILE_COLS = LANES * PER_LANE  # column boxes of a tile
WARPS = 8  # warps of a block
# Persistent blocks per SM, as the kernel's __launch_bounds__ asks for them;
# were fewer resident, the warps would run in turn and still cover the matrix.
BLOCKS_PER_SM = 4
# Above this N * K the kernel takes 64-bit indices: its 32-bit ones reach N * K
# plus two tiles.
INDEX32_MAX = 2**31 - 1 - 2 * TILE_COLS

# Launches of the kernel (one per call that reaches the card).
LAUNCHES = 0

_fns = None


def _launcher():
    global _fns
    if _fns is None:
        from aznet_tpu_torch import _build

        lib = _build.load()
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = lib.aznet_iou_launch
        fn.argtypes = [p, p, q, q, ctypes.c_float, i, q, q, i, p, p]
        fn.restype = i
        lib.aznet_cuda_error_string.argtypes = [i]
        lib.aznet_cuda_error_string.restype = ctypes.c_char_p
        _fns = (fn, lib.aznet_cuda_error_string)
    return _fns


def launch_plan(n: int, k: int, sms: int) -> tuple[int, int, int]:
    """``(blocks, share, extra)`` that the C entry launches. The matrix is
    S = tiles * N (128-column tile, row) slices, column tile major. Where S
    exceeds the :data:`WARPS` warps of :data:`BLOCKS_PER_SM` blocks per SM,
    those blocks persist and each warp takes ``share`` slices in order, the
    first ``extra`` one more. Otherwise ``share`` is 0 and each of S 1-warp
    blocks takes one slice on a (row, tile) grid, so that no warp divides to
    find its slice."""
    slices = -(-k // TILE_COLS) * n
    blocks = sms * BLOCKS_PER_SM
    if slices <= blocks * WARPS:
        return slices, 0, 0
    share, extra = divmod(slices, blocks * WARPS)
    return blocks, share, extra


def warp_rows(n: int, plan: tuple[int, int, int], block: int, w: int):
    """What warp ``w`` of block ``block`` of the launch ``plan``
    (:func:`launch_plan`) computes, in order, as the kernel's index
    arithmetic walks it: ``(row0, row1, col0)``, rows ``row0 .. row1 - 1``
    against the tile of 128 columns from ``col0``."""
    _, share, extra = plan
    if share == 0:  # block b is row b % N of tile b // N
        yield block % n, block % n + 1, block // n * TILE_COLS
        return
    warp = block * WARPS + w
    left = share + (warp < extra)
    tile, r0 = divmod(warp * share + min(warp, extra), n)
    while left > 0:
        rows = min(left, n - r0)
        yield r0, r0 + rows, tile * TILE_COLS
        left -= rows
        tile, r0 = tile + 1, 0


def lane_columns(k: int, col0: int) -> np.ndarray:
    """``[32, 4]`` columns each lane computes in the tile at ``col0``, -1
    where masked: 4 adjacent columns a lane (one 16-byte store) when K % 4
    == 0, else columns ``lane + 32 s`` (4-byte stores)."""
    lane, s = np.arange(LANES)[:, None], np.arange(PER_LANE)[None, :]
    j = col0 + (lane * PER_LANE + s if k % 4 == 0 else lane + s * LANES)
    return np.where(j < k, j, -1)


def _f32_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous float32 starting on 16 bytes (the kernel reads a
    box as one float4), copied only where it is not one already."""
    if t.dtype != torch.float32:
        t = t.float()
    if not t.is_contiguous():
        t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def bbox_overlaps_cuda(boxes: torch.Tensor, query_boxes: torch.Tensor,
                       offset: float = 1.0) -> torch.Tensor:
    """IoU of ``boxes [N, 4]`` against ``query_boxes [K, 4]`` -> float32
    ``[N, K]``, ``+offset`` areas, 0 where the union is <= 0. Float boxes on
    one CUDA device, cast to float32 as the reference casts them; raises on
    anything else."""
    global LAUNCHES
    dev = boxes.device
    if not (boxes.is_cuda and query_boxes.is_cuda) or query_boxes.device != dev:
        raise ValueError("bbox_overlaps_cuda takes CUDA tensors on one device")
    if not (boxes.is_floating_point() and query_boxes.is_floating_point()):
        raise TypeError(f"boxes must be float, got {boxes.dtype} and {query_boxes.dtype}")
    if boxes.ndim != 2 or query_boxes.ndim != 2 or boxes.shape[1] != 4 or query_boxes.shape[1] != 4:
        raise ValueError(f"shapes {tuple(boxes.shape)} and {tuple(query_boxes.shape)}, "
                         f"expected [N, 4] and [K, 4]")
    n, k = boxes.shape[0], query_boxes.shape[0]
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    if n == 0 or k == 0:
        return out
    boxes, query_boxes = _f32_aligned(boxes), _f32_aligned(query_boxes)
    fn, err_str = _launcher()
    idx = dev.index
    args = (boxes.data_ptr(), query_boxes.data_ptr(), n, k, float(offset),
            *launch_plan(n, k, sm_count(idx)), n * k > INDEX32_MAX, out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(idx))
    if idx == torch.cuda.current_device():
        err = fn(*args)
    else:  # the launch goes to the current device's context
        with torch.cuda.device(idx):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"IoU kernel launch failed: {err_str(err).decode()} ({err})")
    LAUNCHES += 1
    return out
