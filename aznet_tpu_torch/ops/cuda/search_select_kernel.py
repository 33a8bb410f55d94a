"""The zoom search's seed and selection on the card: wrapper of
``aznet_tpu_torch/csrc/search_select.cu``.

Replaces no TPU kernel (XLA fuses the JAX package's seed and selection into
its compiled search): eager PyTorch ran them as about 60 small kernels an
image, and their dispatch, not the card, was the cost. Three launches a
search: :func:`search_seed_cuda` before the first head call (the seed
frontier, the level kernel's extent and the candidate buffers), then
:func:`search_cap_cuda` and :func:`search_topk_cuda` around the NMS kernel
(``nms_kernel.py``, unchanged), which ranks the rows in its own order.

Only CUDA tensors are accepted; the plain PyTorch versions are
``aznet_tpu_torch.search.propose.seed_plain`` and ``select_plain``, equal
bit for bit, and the dispatch is ``search_candidates`` and ``az_search``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

DIVISIONS = 5
# How the kernel reads an extent that lies on the card (ExtentKind in the
# source); kind 0 passes a number by value.
EXTENT_KINDS = {torch.float32: 1, torch.int32: 2}

# Launches of the three kernels (three a search that reaches the card).
LAUNCHES = 0

_fns = None


def _launchers():
    global _fns
    if _fns is None:
        from aznet_tpu_torch import _build

        lib = _build.load()
        p, i, q, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        seed, cap, topk = lib.aznet_search_seed, lib.aznet_search_cap, lib.aznet_search_topk
        seed.argtypes = [p, i, f, p, i, f, p, i, i, q, f, f, p, p, p, p, p, p]
        cap.argtypes = [p, p, i, i, f, f, p, p, p, p]
        topk.argtypes = [p, p, p, i, i, p, p, p, p]
        for fn in (seed, cap, topk):
            fn.restype = i
        lib.aznet_cuda_error_string.argtypes = [i]
        lib.aznet_cuda_error_string.restype = ctypes.c_char_p
        _fns = (seed, cap, topk, lib.aznet_cuda_error_string)
    return _fns


def _launch(fn, args, dev: torch.device, what: str) -> None:
    global LAUNCHES
    idx = dev.index
    args = (*args, torch._C._cuda_getCurrentRawStream(idx))
    if idx == torch.cuda.current_device():
        err = fn(*args)
    else:  # the launch goes to the current device's context
        with torch.cuda.device(idx):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {_launchers()[3](err).decode()} "
                           f"({err})")
    LAUNCHES += 1


def _extent(v, dev: torch.device):
    """``(pointer, kind, value, tensor)`` of one extent: a one-element
    tensor on ``dev`` by pointer (cast to float32 on the card where the
    kernel does not read its dtype), anything else by value as float32."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise ValueError(f"an extent is one number, got shape {tuple(v.shape)}")
        if v.device == dev:
            kind = EXTENT_KINDS.get(v.dtype)
            if kind is None:
                v, kind = v.to(torch.float32), 1
            return v.data_ptr(), kind, 0.0, v
        v = v.to(torch.float32).item()
    return None, 0, float(v), None


def search_seed_cuda(im_h, im_w, divisions: np.ndarray, n_seed: int, cap: int, total: int,
                     *, offset: float, neg_inf: float, device: torch.device):
    """The seed of one search on ``device``: ``(extent [2], f_boxes [cap,
    4], f_valid [cap], cand_boxes [total, 4], cand_scores [total])``, the
    first ``n_seed`` frontier rows the whole ``im_h`` x ``im_w`` image and
    its divisions by ``divisions [5, 4]`` (float32 NumPy), level by level.
    The extents are numbers or one-element tensors."""
    if device.type != "cuda":
        raise ValueError(f"search_seed_cuda runs on a CUDA device, got {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if divisions.dtype != np.float32 or divisions.shape != (DIVISIONS, 4) \
            or not divisions.flags.c_contiguous:
        raise ValueError(f"a C-contiguous float32 ({DIVISIONS}, 4) table, got "
                         f"{divisions.dtype} {divisions.shape}")
    if not 1 <= n_seed <= cap:
        raise ValueError(f"{n_seed} seed rows do not fit a frontier of {cap}")
    h_ptr, h_kind, h_value, h_keep = _extent(im_h, device)
    w_ptr, w_kind, w_value, w_keep = _extent(im_w, device)
    extent = torch.empty(2, dtype=torch.float32, device=device)
    f_boxes = torch.empty((cap, 4), dtype=torch.float32, device=device)
    f_valid = torch.empty(cap, dtype=torch.bool, device=device)
    cand_boxes = torch.empty((total, 4), dtype=torch.float32, device=device)
    cand_scores = torch.empty(total, dtype=torch.float32, device=device)
    _launch(_launchers()[0], (
        h_ptr, h_kind, h_value, w_ptr, w_kind, w_value, divisions.ctypes.data, n_seed, cap,
        total, offset, neg_inf, extent.data_ptr(), f_boxes.data_ptr(), f_valid.data_ptr(),
        cand_boxes.data_ptr(), cand_scores.data_ptr()), device, "search seed")
    del h_keep, w_keep  # alive until the launch is queued
    return extent, f_boxes, f_valid, cand_boxes, cand_scores


def _check(tensors, what: str):
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev and t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous CUDA tensors on one device")
    return dev


def search_cap_cuda(boxes: torch.Tensor, scores: torch.Tensor, cap: int, thresh: float,
                    neg_inf: float):
    """The candidates ``boxes [N, 4]`` / ``scores [N]`` (float32) capped at
    ``cap`` rows by score, ties to the lower index (all ``N`` in their order
    where ``N <= cap``), and thresholded: ``(boxes, final, live)``, ``final =
    score >= thresh ? score : neg_inf`` and ``live = final > neg_inf``. The
    boxes are ``boxes`` itself where nothing is cut."""
    dev = _check((boxes, scores), "search_cap_cuda")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"boxes/scores must be float32, got {boxes.dtype}/{scores.dtype}")
    n = scores.shape[0]
    if scores.ndim != 1 or boxes.shape != (n, 4) or boxes.data_ptr() % 16 or n < 1:
        raise ValueError(f"boxes [N, 4] (16-byte aligned) and scores [N], N >= 1: got "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}")
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    rows = min(n, cap)
    out_boxes = torch.empty((rows, 4), dtype=torch.float32, device=dev) if n > cap else boxes
    final = torch.empty(rows, dtype=torch.float32, device=dev)
    live = torch.empty(rows, dtype=torch.bool, device=dev)
    _launch(_launchers()[1], (boxes.data_ptr(), scores.data_ptr(), n, cap, thresh, neg_inf,
                              out_boxes.data_ptr(), final.data_ptr(), live.data_ptr()),
            dev, "search cap")
    return out_boxes, final, live


def search_topk_cuda(keep: torch.Tensor, final: torch.Tensor, boxes: torch.Tensor, k: int):
    """After NMS: the kept rows of ``keep [N]`` (bool; every kept row's
    ``final`` above the search's NEG_INF, as NMS keeps only live rows)
    ranked by ``final [N]`` descending, ties to the lower index, the first
    ``k``: ``(boxes [k, 4], scores [k], valid [k])``, zero rows past the kept
    ones (``ops/nms.py::nms_topk``'s output)."""
    dev = _check((keep, final, boxes), "search_topk_cuda")
    if keep.dtype != torch.bool or final.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise TypeError(f"keep bool, final and boxes float32: got {keep.dtype}, {final.dtype}, "
                        f"{boxes.dtype}")
    n = final.shape[0]
    if keep.shape != (n,) or boxes.shape != (n, 4) or boxes.data_ptr() % 16 or n < 1:
        raise ValueError(f"keep [N], final [N], boxes [N, 4] (16-byte aligned), N >= 1: got "
                         f"{tuple(keep.shape)}, {tuple(final.shape)}, {tuple(boxes.shape)}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    out_boxes = torch.empty((k, 4), dtype=torch.float32, device=dev)
    out_scores = torch.empty(k, dtype=torch.float32, device=dev)
    out_valid = torch.empty(k, dtype=torch.bool, device=dev)
    _launch(_launchers()[2], (keep.data_ptr(), final.data_ptr(), boxes.data_ptr(), n, k,
                              out_boxes.data_ptr(), out_scores.data_ptr(), out_valid.data_ptr()),
            dev, "search top-k")
    return out_boxes, out_scores, out_valid
