"""One level of the zoom search on the card, after the head: wrapper of
``aznet_tpu_torch/csrc/search_level.cu``.

Replaces no TPU kernel (XLA fuses the JAX package's level inside its
compiled loop): eager PyTorch ran the level's decode, division and frontier
top-k as about 95 small kernels, and their dispatch bounded the search. One
block a call: the frontier's keys, the candidates written straight into the
search's candidate buffer, a bitonic sort of ``max(5R, next_cap)`` keys
rounded up to a power of two (at most :data:`MAX_KEYS`), the next frontier.

Only CUDA tensors are accepted; the plain PyTorch version is
``aznet_tpu_torch.search.propose.level_step``, equal bit for bit, and the
dispatch is ``aznet_tpu_torch.search.propose.search_candidates``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

MAX_TEMPLATES = 16  # the kernel's template table, passed by value
DIVISIONS = 5
MAX_KEYS = 16384  # 128 KB of sort keys in shared memory

# Launches of the kernel (one per search level that reaches the card).
LAUNCHES = 0

_fns = None


def _launcher():
    global _fns
    if _fns is None:
        from aznet_tpu_torch import _build

        lib = _build.load()
        p, i, q, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn = lib.aznet_search_level
        fn.argtypes = [p, q, p, q, q, p, q, q, q, p, p, p, p, i, p, i, i, f, f, f, f, f,
                       p, p, p, p, p]
        fn.restype = i
        lib.aznet_cuda_error_string.argtypes = [i]
        lib.aznet_cuda_error_string.restype = ctypes.c_char_p
        _fns = (fn, lib.aznet_cuda_error_string)
    return _fns


def sort_width(r: int, next_cap: int) -> int:
    """Keys the kernel sorts for ``r`` regions and ``next_cap`` frontier
    slots: the next power of two of ``max(5r, next_cap)``; raises above
    :data:`MAX_KEYS`."""
    need = max(DIVISIONS * r, next_cap)
    width = 1 << (need - 1).bit_length()
    if width > MAX_KEYS:
        raise ValueError(f"the search-level kernel sorts at most {MAX_KEYS} keys: R={r} "
                         f"regions and next_cap={next_cap} need {width}")
    return width


def _table(t: np.ndarray, rows: int) -> np.ndarray:
    if t.dtype != np.float32 or t.shape != (rows, 4) or not t.flags.c_contiguous:
        raise ValueError(f"a C-contiguous float32 ({rows}, 4) table, got {t.dtype} {t.shape}")
    return t


def search_level_cuda(zoom, adj_score, adj_delta, f_boxes, f_valid, extent,
                      templates: np.ndarray, divisions: np.ndarray, next_cap: int,
                      cand_boxes, cand_scores, start: int, *, offset: float,
                      zoom_thresh: float, min_size: float, clip: float | None,
                      neg_inf: float):
    """One level after the head. ``zoom [R]``, ``adj_score [R, K]`` (logits)
    and ``adj_delta [R, K, 4]`` float32 in any strides; the frontier
    ``f_boxes [R, 4]`` float32 and ``f_valid [R]`` bool; ``extent [2]`` the
    valid (h, w); the ``templates [K, 4]`` and ``divisions [5, 4]`` tables
    as float32 NumPy. Writes the R * K candidates' boxes and scores into rows
    ``start ..`` of ``cand_boxes [N, 4]`` / ``cand_scores [N]`` and returns
    the next frontier ``(boxes [next_cap, 4], valid [next_cap])``. Tensors
    on one CUDA device; raises on anything else."""
    global LAUNCHES
    dev = f_boxes.device
    tensors = (zoom, adj_score, adj_delta, f_boxes, f_valid, extent, cand_boxes, cand_scores)
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("search_level_cuda takes CUDA tensors on one device")
    if any(t.dtype != torch.float32 for t in tensors if t is not f_valid):
        raise TypeError("search_level_cuda takes float32 head outputs, boxes and buffers")
    if f_valid.dtype != torch.bool:
        raise TypeError(f"f_valid must be bool, got {f_valid.dtype}")
    if adj_score.ndim != 2:
        raise ValueError(f"adj_score must be [R, K], got {tuple(adj_score.shape)}")
    r, k = adj_score.shape
    if (zoom.shape != (r,) or adj_delta.shape != (r, k, 4) or f_boxes.shape != (r, 4)
            or f_valid.shape != (r,) or extent.shape != (2,)):
        raise ValueError(f"shapes zoom {tuple(zoom.shape)}, adj_score {(r, k)}, adj_delta "
                         f"{tuple(adj_delta.shape)}, f_boxes {tuple(f_boxes.shape)}, f_valid "
                         f"{tuple(f_valid.shape)}, extent {tuple(extent.shape)}")
    if not 1 <= k <= MAX_TEMPLATES:
        raise ValueError(f"K must be in [1, {MAX_TEMPLATES}], got {k}")
    sort_width(r, next_cap)
    templates, divisions = _table(templates, k), _table(divisions, DIVISIONS)
    n = cand_scores.shape[0]
    if (cand_boxes.shape != (n, 4) or not cand_boxes.is_contiguous()
            or not cand_scores.is_contiguous() or cand_boxes.data_ptr() % 16):
        raise ValueError("the candidate buffers must be contiguous [N, 4] (16-byte aligned) "
                         "and [N]")
    if not 0 <= start <= n - r * k:
        raise ValueError(f"rows {start}..{start + r * k} outside the candidate buffer of {n}")
    f_boxes, f_valid, extent = f_boxes.contiguous(), f_valid.contiguous(), extent.contiguous()
    if f_boxes.data_ptr() % 16:  # the kernel reads a box as one float4
        f_boxes = f_boxes.clone()
    next_boxes = torch.empty((next_cap, 4), dtype=torch.float32, device=dev)
    next_valid = torch.empty((next_cap,), dtype=torch.bool, device=dev)
    fn, err_str = _launcher()
    idx = dev.index
    args = (zoom.data_ptr(), zoom.stride(0), adj_score.data_ptr(), *adj_score.stride(),
            adj_delta.data_ptr(), *adj_delta.stride(), f_boxes.data_ptr(), f_valid.data_ptr(),
            extent.data_ptr(), templates.ctypes.data, k, divisions.ctypes.data, r, next_cap,
            zoom_thresh, min_size, float("inf") if clip is None else clip, offset, neg_inf,
            cand_boxes.data_ptr() + 16 * start, cand_scores.data_ptr() + 4 * start,
            next_boxes.data_ptr(), next_valid.data_ptr(), torch._C._cuda_getCurrentRawStream(idx))
    if idx == torch.cuda.current_device():
        err = fn(*args)
    else:  # the launch goes to the current device's context
        with torch.cuda.device(idx):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"search-level kernel launch failed: {err_str(err).decode()} ({err})")
    LAUNCHES += 1
    return next_boxes, next_valid

