"""Fused conv1_2 + ReLU + pool1 on the card: wrappers of
``aznet_tpu_torch/csrc/conv1_fused.cu`` (bf16) and
``aznet_tpu_torch/csrc/conv1_fused_f32.cu`` (float32).

Both replace ``aznet_tpu/ops/pallas/conv1_kernel.py::fused_conv1_pool`` (its
Pallas part, which runs in the input's dtype; conv1_1 runs outside, as
there). :func:`conv1_2_pool_cuda`, bf16: an implicit GEMM on the bf16 tensor
cores (``wgmma`` m64n128k16, f32 accumulation) with the output channels as M
and 128 pixels of a row as N, the weights resident in shared memory, the
halo patch brought by TMA into a ring of stages, and persistent blocks that
walk tiles of 2 rows x 128 columns; bias, ReLU and the 2x2/2 max-pool close
in registers (see the source's header). Bound by compute at VGG-16's shape.
:func:`conv1_2_pool_cuda_f32`, float32: the same implicit GEMM with 64
pixels of a row as N on the TF32 tensor cores (``wgmma`` m64n64k8), each
product taken as three TF32 products of the operands' hi and lo parts
(3xTF32), the weights resident in shared memory and split in registers, the
patch brought by TMA and split into hi and lo planes, persistent blocks over
tiles of 2 rows x 64 columns; each tensor-core sum of at most two k8 steps'
products is promoted into float32 partial sums, one per kernel row, in the
order of
:func:`f32_promotions`, so the result keeps float32's error
(``ops/conv1_fused.py::float64_errors``).

Only CUDA tensors are accepted; the plain PyTorch version is
``aznet_tpu_torch.ops.conv1_fused.conv1_2_pool_reference`` and the dispatch
(by ``y``'s dtype) is ``aznet_tpu_torch.ops.conv1_fused.fused_conv1_pool``.
"""

from __future__ import annotations

import ctypes

import torch

from aznet_tpu_torch.ops.cuda import sm_count

MAX_CHANNELS = 64  # C and Co: the resident weights and the wgmma M
CHANNEL_MULTIPLE = 8  # C and Co: TMA's 16-byte rows, the 16-byte output stores
TILE_COLS = 128  # output columns per tile = wgmma N (bf16)
TILE_COLS_F32 = 64  # the same for the float32 kernel
CONSUMERS = 2  # consumer warpgroups per block; the block's k-th tile goes to k % 2

# Launches of the bf16 and the float32 kernel (one per call that reaches the card).
LAUNCHES = 0
LAUNCHES_F32 = 0

_fns = None


def _launcher():
    global _fns
    if _fns is None:
        from aznet_tpu_torch import _build

        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.aznet_conv1_fused
        fn.argtypes = [p, p, p, i, i, i, i, i, i, p, p]
        fn.restype = i
        fn32 = lib.aznet_conv1_fused_f32
        fn32.argtypes = [p, p, p, i, i, i, i, i, i, p, p]
        fn32.restype = i
        lib.aznet_cuda_error_string.argtypes = [i]
        lib.aznet_cuda_error_string.restype = ctypes.c_char_p
        _fns = (fn, fn32, lib.aznet_cuda_error_string)
    return _fns


def num_tiles(b: int, h: int, w: int, cols: int = TILE_COLS) -> int:
    """Tiles of a ``[b, h, w, C]`` input: (image, row pair, ``cols``-column
    segment)."""
    return b * (h // 2) * -(-w // cols)


def grid_size(tiles: int, sms: int) -> int:
    """Persistent blocks: one per SM, but no more than gives each of a
    block's two consumer warpgroups a tile."""
    return max(1, min(sms, -(-tiles // CONSUMERS)))


def tile_walk(b: int, h: int, w: int, grid: int, cols: int = TILE_COLS):
    """The kernels' persistent order, as they walk it: ``{(block,
    warpgroup): [(image, row pair, segment), ...]}`` (block x takes tiles x,
    x + grid, ...; its k-th tile goes to warpgroup k % 2); segments of
    ``cols`` columns."""
    tiles, segs, pairs = num_tiles(b, h, w, cols), -(-w // cols), h // 2
    walk = {}
    for x in range(grid):
        for k, t in enumerate(range(x, tiles, grid)):
            walk.setdefault((x, k % CONSUMERS), []).append(
                (t // segs // pairs, (t // segs) % pairs, t % segs))
    return walk


def f32_promotions(c: int):
    """The float32 kernel's order of accumulation for ``c`` input channels:
    for each kernel row dy in turn, its promotion groups in order, each
    ``(steps, unbias)`` with ``steps`` a list of (tap, k8 step). A group is
    the steps of one tap in one 16-channel chunk (one TMA stage), taps dx =
    0, 1, 2 in turn: two steps, or one where C ends in the chunk's first
    half. Its steps' TF32 products (lo_w.hi_y, hi_w.lo_y, hi_w.hi_y a step)
    go through one tensor-core accumulator, the first from zero; the group's
    sum is then added into dy's float32 partial in one rounding, as
    ``__fmaf_rn(acc, 1 + 2**-23, partial)`` where ``unbias`` (every two-step
    group, and a one-step group's dx = 2), which gives back on average what
    the accumulator's truncations dropped, else as ``acc + partial``; after
    dy the partial is added into the total."""
    steps = c // 8
    return [[([(3 * dy + dx, s) for s in range(2 * i, min(2 * i + 2, steps))],
              2 * i + 1 < steps or dx == 2)
             for i in range(-(-steps // 2)) for dx in range(3)] for dy in range(3)]


def _check(y: torch.Tensor, w_k: torch.Tensor, bias: torch.Tensor, dtype, w_shape):
    """Validate the operands for the kernel of ``dtype``, whose weight layout
    for C input channels has shape ``w_shape(C)``; returns (B, H, W, C, Co)."""
    tensors = (y, w_k, bias)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("the fused conv1 kernel takes CUDA tensors on one device")
    name = {torch.bfloat16: "bf16", torch.float32: "float32"}[dtype]
    if y.dtype != dtype or w_k.dtype != dtype:
        raise TypeError(f"the {name} fused conv1 kernel takes {name} y and w_k, "
                        f"got {y.dtype}/{w_k.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    if y.ndim != 4 or bias.ndim != 1:
        raise ValueError(f"shapes y {tuple(y.shape)}, bias {tuple(bias.shape)}")
    b, h, w, c = y.shape
    co = bias.shape[0]
    for label, n in (("C", c), ("Co", co)):
        if n % CHANNEL_MULTIPLE or not 0 < n <= MAX_CHANNELS:
            raise ValueError(f"the fused conv1 kernel takes {label} a multiple of "
                             f"{CHANNEL_MULTIPLE} up to {MAX_CHANNELS}, got {n}")
    if w_k.shape != w_shape(c):
        raise ValueError(f"w_k {tuple(w_k.shape)} is not the {name} kernel's tiled layout "
                         f"for C={c}")
    if h % 2 or w % 2:
        raise ValueError(f"the fused 2x2 pool needs even H and W, got {h}x{w}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the fused conv1 kernel needs contiguous tensors")
    if y.data_ptr() % 16 or w_k.data_ptr() % 16:
        raise ValueError("y and w_k must be 16-byte aligned")
    if num_tiles(b, h, w, TILE_COLS_F32) >= 2**31:
        raise ValueError(f"too many tiles for y {tuple(y.shape)}")
    return b, h, w, c, co


def _raise_on(err: int):
    if err != 0:
        raise RuntimeError(f"fused conv1 kernel launch failed: "
                           f"{_launcher()[2](err).decode()} ({err})")


def conv1_2_pool_cuda(y: torch.Tensor, w_k: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``y [B, H, W, C]`` bf16 (H, W even), ``w_k`` the tiled bf16 weights
    ``[ceil(C/16), 9, 2, 64, 8]`` (``ops/conv1_fused.py::kernel_layout``),
    ``bias [Co]`` f32, contiguous on one CUDA device -> bf16 ``[B, H/2, W/2,
    Co]``: 3x3 SAME conv, + bias, ReLU, 2x2/2 max-pool. C and Co must be
    multiples of 8 and at most 64. Raises on anything else."""
    global LAUNCHES
    b, h, w, c, co = _check(y, w_k, bias, torch.bfloat16,
                            lambda c: (-(-c // 16), 9, 2, MAX_CHANNELS, 8))
    out = torch.empty((b, h // 2, w // 2, co), dtype=torch.bfloat16, device=y.device)
    if out.numel() == 0:
        return out
    fn = _launcher()[0]
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), w_k.data_ptr(), bias.data_ptr(), b, h, w, c, co,
                 grid_size(num_tiles(b, h, w), sm_count(y.device.index)), out.data_ptr(),
                 stream)
    _raise_on(err)
    LAUNCHES += 1
    return out


def conv1_2_pool_cuda_f32(y: torch.Tensor, w_k: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``y [B, H, W, C]`` float32 (H, W even), ``w_k`` the float32 weights
    ``[9, C/8, 128, 4]`` (``ops/conv1_fused.py::kernel_layout_f32``), ``bias
    [Co]`` f32, contiguous on one CUDA device -> float32 ``[B, H/2, W/2,
    Co]``: 3x3 SAME conv, + bias, ReLU, 2x2/2 max-pool, to float32's error
    (3xTF32 on the tensor cores). C and Co must be multiples of 8 and at
    most 64. Raises on anything else."""
    global LAUNCHES_F32
    b, h, w, c, co = _check(y, w_k, bias, torch.float32, lambda c: (9, c // 8, 128, 4))
    out = torch.empty((b, h // 2, w // 2, co), dtype=torch.float32, device=y.device)
    if out.numel() == 0:
        return out
    fn = _launcher()[1]
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), w_k.data_ptr(), bias.data_ptr(), b, h, w, c, co,
                 grid_size(num_tiles(b, h, w, TILE_COLS_F32), sm_count(y.device.index)),
                 out.data_ptr(), stream)
    _raise_on(err)
    LAUNCHES_F32 += 1
    return out
