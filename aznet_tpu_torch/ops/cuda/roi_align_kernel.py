"""Fused ROI align on the card: wrapper of ``aznet_tpu_torch/csrc/roi_align.cu``.

Replaces ``aznet_tpu/ops/pallas/roi_kernel.py`` (``roi_align_pallas`` and
its two large-map tilings, ``roi_align_pallas_big`` and ``_big_v2``): one
kernel with an H-first / W-first flag. One block per (roi, channel slab,
group of second-axis bins); a thread owns one bin of the first axis and 8
channels (16-byte loads and stores), and computes the first contraction
once per distinct cell its second-axis bins read. It is bound by L2 traffic
and load latency: at most 4 x 4 taps per output value, no tensor cores.

Only CUDA tensors are accepted; the plain PyTorch version is
``aznet_tpu_torch.ops.roi_pool.roi_align_fused_reference`` and the dispatch
is ``aznet_tpu_torch.ops.roi_pool.roi_align_fused``.
"""

from __future__ import annotations

import ctypes

import torch

from aznet_tpu_torch.ops.cuda import sm_count

MAX_POOL = 16  # the kernel's shared tap tables hold up to 16 bins per axis
VEC = 8  # channels per thread
MAX_SLAB_THREADS = 32  # threads per first-axis bin of a block
BLOCKS_PER_SM = 2  # what launch_plan aims for at small R

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
        fn.argtypes = [p, p, i, i, i, i, ctypes.c_float, i, i, i, i, i, p, p]
        fn.restype = i
        lib.aznet_cuda_error_string.argtypes = [i]
        lib.aznet_cuda_error_string.restype = ctypes.c_char_p
        _fns = (fn, lib.aznet_cuda_error_string)
    return _fns


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
    fn, err_str = _launcher()
    idx = dev.index
    s, per = launch_plan(r, c, pool_size, sm_count(idx))
    args = (feat.data_ptr(), rois.data_ptr(), r, h, w, c, float(spatial_scale), pool_size,
            int(w_first), feat.dtype == torch.bfloat16, s, per, out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(idx))
    if idx == torch.cuda.current_device():
        err = fn(*args)
    else:  # the launch goes to the current device's context
        with torch.cuda.device(idx):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"ROI-align kernel launch failed: {err_str(err).decode()} ({err})")
    LAUNCHES += 1
    return out
