"""Fused ROI align on the card: wrapper of ``aznet_tpu_torch/csrc/roi_align.cu``.

Replaces ``aznet_tpu/ops/pallas/roi_kernel.py`` (``roi_align_pallas`` and
its two large-map tilings, ``roi_align_pallas_big`` and ``_big_v2``): one
kernel with an H-first / W-first flag. One block per (roi, channel slab,
group of second-axis bins); a thread owns one bin of the first axis and 8
channels (16-byte loads and stores), and computes the first contraction
once per distinct cell its second-axis bins read. It is bound by L2 traffic
and load latency: at most 4 x 4 taps per output value, no tensor cores.

A second entry, ``roi_align_levels_cuda`` (``roi_align_levels_kernel``, no
TPU counterpart: the JAX package has no feature pyramid), takes an image's
levels (up to four maps, finest first) and its rois in one launch: each
block finds its roi's level from the roi's +1 area (FPN's eq. 1 as
comparisons with each coarser level's least area) and pools it with the
same device code and launch plan, from that level's map, at its scale and
in its contraction order. The split of the rois over the levels depends on
the data and never reaches the host.

Only CUDA tensors are accepted; the plain PyTorch versions are
``aznet_tpu_torch.ops.roi_pool.roi_align_fused_reference`` and
``roi_align_levels_reference``, the dispatches ``roi_align_fused`` and
``roi_align_levels`` there.
"""

from __future__ import annotations

import ctypes

import torch

from aznet_tpu_torch.ops.cuda import sm_count

MAX_POOL = 16  # the kernel's shared tap tables hold up to 16 bins per axis
VEC = 8  # channels per thread
MAX_SLAB_THREADS = 32  # threads per first-axis bin of a block
BLOCKS_PER_SM = 2  # what launch_plan aims for at small R
MAX_LEVELS = 4  # the maps one launch of the levels entry takes

# Launches of each entry (one per call that reaches the card).
LAUNCHES = 0
LAUNCHES_LEVELS = 0

_fns = None


def _launcher():
    global _fns
    if _fns is None:
        from aznet_tpu_torch import _build

        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.aznet_roi_align
        fn.argtypes = [p, p, i, i, i, i, ctypes.c_float, i, i, i, i, i, p, p]
        fn.restype = i
        levels = lib.aznet_roi_align_levels
        levels.argtypes = [p, p, p, p, p, p, i, p, i, i, i, i, i, i, p, p]
        levels.restype = i
        lib.aznet_cuda_error_string.argtypes = [i]
        lib.aznet_cuda_error_string.restype = ctypes.c_char_p
        _fns = (fn, levels, lib.aznet_cuda_error_string)
    return _fns


def _launch(fn, err_str, idx: int, args, what: str) -> None:
    """``fn(*args)`` in device ``idx``'s context; raises on a failed launch."""
    if idx == torch.cuda.current_device():
        err = fn(*args)
    else:  # the launch goes to the current device's context
        with torch.cuda.device(idx):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {err_str(err).decode()} ({err})")


def launch_plan(r: int, c: int, pool: int, sms: int) -> tuple[int, int]:
    """``(slab_threads, per)``: each block covers ``slab_threads * 8``
    channels and ``per`` bins of the second axis. Slabs are up to 256
    channels wide; the second axis is split into groups only as far as
    needed to give every SM ``BLOCKS_PER_SM`` blocks (a group shares its
    cells' first contraction, so R=300 keeps all P bins in one block)."""
    s = min(MAX_SLAB_THREADS, 1 << (-(-c // VEC) - 1).bit_length())
    blocks = r * -(-c // (VEC * s))
    groups = min(pool, max(1, -(-BLOCKS_PER_SM * sms // blocks)))
    return s, -(-pool // groups)


def block_work(c: int, pool: int, slab_threads: int, per: int, block_y: int, thread: int):
    """What thread ``thread`` of a block with ``blockIdx.y == block_y``
    computes, as the kernel's index arithmetic has it: ``(first-axis bin,
    second-axis bins, channels)``, or None for a thread past C."""
    groups = -(-pool // per)
    i = thread // slab_threads
    slab, grp = divmod(block_y, groups)
    ch = (slab * slab_threads + thread - i * slab_threads) * VEC
    if ch >= c:
        return None
    return i, range(grp * per, min(pool, (grp + 1) * per)), range(ch, min(c, ch + VEC))


def roi_align_cuda(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
                   pool_size: int, w_first: bool) -> torch.Tensor:
    """``feat [H, W, C]`` bf16/f32 and ``rois [R, 4]`` f32 on one CUDA device
    -> ``[R, P, P, C]`` in ``feat``'s dtype. Raises on anything else."""
    global LAUNCHES
    dev = feat.device
    if not (feat.is_cuda and rois.is_cuda) or rois.device != dev:
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
    out = torch.empty((r, pool_size, pool_size, c), dtype=feat.dtype, device=dev)
    if r == 0 or c == 0:
        return out
    fn, _, err_str = _launcher()
    idx = dev.index
    s, per = launch_plan(r, c, pool_size, sm_count(idx))
    _launch(fn, err_str, idx, (feat.data_ptr(), rois.data_ptr(), r, h, w, c, float(spatial_scale),
                               pool_size, int(w_first), feat.dtype == torch.bfloat16, s, per,
                               out.data_ptr(), torch._C._cuda_getCurrentRawStream(idx)),
            "ROI-align kernel")
    LAUNCHES += 1
    return out


def roi_align_levels_cuda(levels, rois: torch.Tensor, strides, pool_size: int, w_first,
                          min_areas) -> torch.Tensor:
    """``levels``: the maps ``[h_l, w_l, C]`` (bf16 or f32, one dtype, one
    CUDA device), finest first, with their ``strides`` and contraction
    orders ``w_first``; ``min_areas``: the least +1 area of a box on each
    level after the first. ``rois [R, 4]`` f32 -> ``[R, P, P, C]`` in the
    maps' dtype, each roi pooled from its own level. Raises on anything
    else."""
    global LAUNCHES_LEVELS
    levels = tuple(levels)
    n = len(levels)
    if not 1 <= n <= MAX_LEVELS or not len(strides) == len(w_first) == n == len(min_areas) + 1:
        raise ValueError(f"1 to {MAX_LEVELS} levels, each with a stride and an order, and "
                         f"{n - 1} least areas; got {n}, {len(strides)}, {len(w_first)}, "
                         f"{len(min_areas)}")
    dev = levels[0].device
    if not (rois.is_cuda and all(f.is_cuda for f in levels)) or any(
            t.device != dev for t in (rois, *levels)):
        raise ValueError("roi_align_levels_cuda takes CUDA tensors on one device")
    dt = levels[0].dtype
    if dt not in (torch.bfloat16, torch.float32) or any(f.dtype != dt for f in levels):
        raise TypeError(f"the levels must be all bf16 or all f32, got {[f.dtype for f in levels]}")
    if rois.dtype != torch.float32:
        raise TypeError(f"rois must be float32, got {rois.dtype}")
    if any(f.ndim != 3 for f in levels) or len({f.shape[2] for f in levels}) != 1 or \
            rois.ndim != 2 or rois.shape[1] != 4:
        raise ValueError(f"shapes levels {[tuple(f.shape) for f in levels]}, rois "
                         f"{tuple(rois.shape)}")
    if not 1 <= pool_size <= MAX_POOL:
        raise ValueError(f"pool_size must be in [1, {MAX_POOL}], got {pool_size}")
    levels, rois = tuple(f.contiguous() for f in levels), rois.contiguous()
    c = levels[0].shape[2]
    r = rois.shape[0]
    out = torch.empty((r, pool_size, pool_size, c), dtype=dt, device=dev)
    if r == 0 or c == 0:
        return out
    _, fn, err_str = _launcher()
    idx = dev.index
    s, per = launch_plan(r, c, pool_size, sm_count(idx))

    def arr(ctype, values):
        return (ctype * n)(*values)

    _launch(fn, err_str, idx, (
        arr(ctypes.c_void_p, [f.data_ptr() for f in levels]),
        arr(ctypes.c_int, [f.shape[0] for f in levels]),
        arr(ctypes.c_int, [f.shape[1] for f in levels]),
        arr(ctypes.c_float, [1.0 / st for st in strides]),
        arr(ctypes.c_int, [int(wf) for wf in w_first]),
        arr(ctypes.c_float, [0.0, *min_areas]), n, rois.data_ptr(), r, c, pool_size,
        dt == torch.bfloat16, s, per, out.data_ptr(), torch._C._cuda_getCurrentRawStream(idx)),
        "ROI-align levels kernel")
    LAUNCHES_LEVELS += 1
    return out
