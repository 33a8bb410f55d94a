"""Int8 3x3 conv on the card: wrapper of ``aznet_tpu_torch/csrc/conv_int8.cu``.

One kernel, two entry points:

- :func:`conv3x3_int8_chain` (conv + ReLU + fused 2x2/2 max-pool, int8 out)
  replaces ``aznet_tpu/ops/pallas/conv_int8_chain.py::conv3x3_int8_chain``;
- :func:`conv3x3_int8_strip` (conv + ReLU, int8 or bf16 out) replaces
  ``aznet_tpu/ops/pallas/conv_int8_kernel.py::conv3x3_int8_pallas``.

The kernel is an implicit GEMM on Hopper's int8 tensor cores (``wgmma``
m64n128k32, two consumer warpgroups, a 4-stage ring under ``mbarrier``s
filled by TMA: the halo patch as 4D boxes, the weight chunk as one bulk copy;
8-byte ``cp.async`` for the patch when C % 16 != 0) over tiles of R rows x
64 columns x 128 output channels, with the epilogue rounded as the
reference's (see the source's header). R is 4, or 2 where that takes the
map less time (:func:`tile_rows`). Activations are compact NHWC int8;
weights come in the tiled layout ``[Co/128, Cp/32, 2, 9, 128, 16]`` of
``ops/conv_int8.py::kernel_layout`` (one contiguous piece per block and
chunk of 32 input channels).

Only CUDA tensors are accepted; the plain PyTorch version is
``aznet_tpu_torch.ops.conv_int8.conv3x3_int8_reference`` and the dispatch is
``aznet_tpu_torch.ops.conv_int8.conv3x3_int8``.
"""

from __future__ import annotations

import ctypes

import torch

from aznet_tpu_torch.ops.cuda import sm_count

K_CHUNK = 32  # input channels per staged chunk: the kernel's Cp is a multiple
TILE_COLS = 64  # output columns per block (the wgmma M)
CO_TILE = 128  # output channels per block (the wgmma N)
GRID_MAX_YZ = 65535

# Launches of the chain and the strip entry (one per call that reaches the card).
LAUNCHES_CHAIN = 0
LAUNCHES_STRIP = 0

_fns = None


def _launchers():
    global _fns
    if _fns is None:
        from aznet_tpu_torch import _build

        lib = _build.load()
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        chain = lib.aznet_conv3x3_int8_chain
        chain.argtypes = [p, p, p, p, i, i, i, i, i, i, i, f, f, p, p]
        chain.restype = i
        strip = lib.aznet_conv3x3_int8_strip
        strip.argtypes = [p, p, p, p, i, i, i, i, i, i, i, f, f, i, p, p]
        strip.restype = i
        lib.aznet_cuda_error_string.argtypes = [i]
        lib.aznet_cuda_error_string.restype = ctypes.c_char_p
        _fns = (chain, strip, lib.aznet_cuda_error_string)
    return _fns


def grid(b: int, h: int, w: int, co: int, rows: int) -> tuple[int, int, int]:
    """The launch grid: (column tiles, row tiles, B x channel tiles)."""
    return -(-w // TILE_COLS), -(-h // rows), b * -(-co // CO_TILE)


def chunk_cycles(rows: int) -> float:
    """Cycles of one block on one SM per chunk of 32 input channels: the
    larger of the tensor cores' time (9 wgmma m64n128k32 of 64 cycles per
    output row) and the chunk's bytes (the 36,864-byte weight piece and the
    (rows+2) x 66 x 32 patch) from L2 at about 24 bytes per cycle per SM (an
    H100's L2 rate shared by its 132 SMs)."""
    return max(9 * 64 * rows, (36864 + (rows + 2) * 66 * 32) / 24)


def tile_rows(b: int, h: int, w: int, co: int, n_sms: int) -> int:
    """Output rows per block: 4, or 2 where blocks of 2 rows take less time
    in waves x :func:`chunk_cycles` on ``n_sms`` multiprocessors (one block
    fits on one): small maps, e.g. conv5 at b=1. Both are even, so a 2x2
    pool window never straddles two blocks."""
    def cost(rows):
        gx, gy, gz = grid(b, h, w, co, rows)
        return -(-(gx * gy * gz) // n_sms) * chunk_cycles(rows)

    return 2 if cost(2) < cost(4) else 4


def tile_config(x: torch.Tensor, co: int) -> dict:
    """The tile the kernel takes for ``x [B, H, W, C]`` on its card and
    ``co`` output channels: rows, columns, channels per block and the grid."""
    b, h, w, _ = x.shape
    rows = tile_rows(b, h, w, co, sm_count(x.device.index))
    return {"rows": rows, "cols": TILE_COLS, "co": CO_TILE, "grid": grid(b, h, w, co, rows)}


def _check(x, w_k, s_w, bias):
    """Validate the operands; returns (B, H, W, C, Cp, Co, rows)."""
    tensors = (x, w_k, s_w, bias)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the int8 conv kernel takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the int8 conv operands must be on one device")
    if x.dtype != torch.int8 or w_k.dtype != torch.int8:
        raise TypeError(f"x and w_k must be int8, got {x.dtype}/{w_k.dtype}")
    if s_w.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"s_w and bias must be float32, got {s_w.dtype}/{bias.dtype}")
    if (x.ndim != 4 or w_k.ndim != 6 or tuple(w_k.shape[2:]) != (2, 9, CO_TILE, K_CHUNK // 2)
            or s_w.ndim != 1):
        raise ValueError(f"shapes x {tuple(x.shape)}, w_k {tuple(w_k.shape)}, s_w {tuple(s_w.shape)}")
    b, h, w, c = x.shape
    co, cp = s_w.shape[0], w_k.shape[1] * K_CHUNK
    if c % 8 or co % 8:
        raise ValueError(f"the kernel takes C and Co that are multiples of 8, got {c}, {co}")
    if cp != -(-c // K_CHUNK) * K_CHUNK or w_k.shape[0] != -(-co // CO_TILE):
        raise ValueError(f"w_k {tuple(w_k.shape)} does not tile C={c} by {K_CHUNK} and "
                         f"Co={co} by {CO_TILE}")
    if bias.shape != (co,):
        raise ValueError(f"bias {tuple(bias.shape)} vs Co={co}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the int8 conv kernel needs contiguous tensors")
    if x.data_ptr() % 8 or w_k.data_ptr() % 16:
        raise ValueError("x must be 8-byte and w_k 16-byte aligned")
    rows = tile_rows(b, h, w, co, sm_count(x.device.index))
    if max(grid(b, h, w, co, rows)[1:]) > GRID_MAX_YZ:
        raise ValueError(f"grid too large for x {tuple(x.shape)}, Co={co}")
    return b, h, w, c, cp, co, rows


def _raise_on(err: int, entry: str):
    if err != 0:
        raise RuntimeError(f"int8 conv {entry} launch failed: "
                           f"{_launchers()[2](err).decode()} ({err})")


def conv3x3_int8_chain(x: torch.Tensor, s_x: float, w_k: torch.Tensor,
                       s_w: torch.Tensor, bias: torch.Tensor,
                       s_out: float) -> torch.Tensor:
    """Chain entry: ``x [B, H, W, C]`` int8 (H, W even) -> int8
    ``[B, H/2, W/2, Co]``, conv + ReLU + 2x2/2 max-pool, requantized at
    ``s_out``."""
    global LAUNCHES_CHAIN
    b, h, w, c, cp, co, rows = _check(x, w_k, s_w, bias)
    if s_out is None:
        raise ValueError("the fused pool is only for chain-interior layers (s_out given)")
    if h % 2 or w % 2:
        raise ValueError(f"the fused 2x2 pool needs even H and W, got {h}x{w}")
    out = torch.empty((b, h // 2, w // 2, co), dtype=torch.int8, device=x.device)
    chain, _, _ = _launchers()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = chain(x.data_ptr(), w_k.data_ptr(), s_w.data_ptr(), bias.data_ptr(),
                    b, h, w, c, cp, co, rows, float(s_x), 1.0 / s_out, out.data_ptr(), stream)
    _raise_on(err, "chain")
    LAUNCHES_CHAIN += 1
    return out


def conv3x3_int8_strip(x: torch.Tensor, s_x: float, w_k: torch.Tensor,
                       s_w: torch.Tensor, bias: torch.Tensor,
                       s_out: float | None = None,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Strip entry: ``x [B, H, W, C]`` int8 -> ``[B, H, W, Co]``, conv + ReLU,
    int8 at ``s_out``, or ``out_dtype`` (bf16 only) when ``s_out`` is None."""
    global LAUNCHES_STRIP
    b, h, w, c, cp, co, rows = _check(x, w_k, s_w, bias)
    if s_out is None and out_dtype != torch.bfloat16:
        raise TypeError(f"the kernel's float exit is bf16, got {out_dtype}")
    out = torch.empty((b, h, w, co), device=x.device,
                      dtype=torch.int8 if s_out is not None else torch.bfloat16)
    _, strip, _ = _launchers()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = strip(x.data_ptr(), w_k.data_ptr(), s_w.data_ptr(), bias.data_ptr(),
                    b, h, w, c, cp, co, rows, float(s_x),
                    0.0 if s_out is None else 1.0 / s_out, int(s_out is None),
                    out.data_ptr(), stream)
    _raise_on(err, "strip")
    LAUNCHES_STRIP += 1
    return out
