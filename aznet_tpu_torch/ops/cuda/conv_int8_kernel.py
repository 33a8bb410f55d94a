"""Int8 3x3 conv on the card: wrapper of ``aznet_tpu_torch/csrc/conv_int8.cu``.

One kernel, two entry points:

- :func:`conv3x3_int8_chain` (conv + ReLU + fused 2x2/2 max-pool, int8 out)
  replaces ``aznet_tpu/ops/pallas/conv_int8_chain.py::conv3x3_int8_chain``;
- :func:`conv3x3_int8_strip` (conv + ReLU, int8 or bf16 out) replaces
  ``aznet_tpu/ops/pallas/conv_int8_kernel.py::conv3x3_int8_pallas``.

The kernel is an implicit GEMM on the int8 tensor cores (``mma.sync``
m16n8k32) over tiles of 2 rows x 32 columns x 128 output channels, with the
epilogue rounded as the reference's (see the source's header). Activations
are compact NHWC int8; weights come in the kernel layout ``[9, Co, Cp]`` of
``ops/conv_int8.py::kernel_layout``.

Only CUDA tensors are accepted; the plain PyTorch version is
``aznet_tpu_torch.ops.conv_int8.conv3x3_int8_reference`` and the dispatch is
``aznet_tpu_torch.ops.conv_int8.conv3x3_int8``.
"""

from __future__ import annotations

import ctypes

import torch

K_CHUNK = 32  # input channels per staged chunk: the kernel's Cp is a multiple

# Launches per entry point (one per call that reaches the card).
LAUNCHES = {"chain": 0, "strip": 0}

_fns = None


def _launchers():
    global _fns
    if _fns is None:
        from aznet_tpu_torch import _build

        lib = _build.load()
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        chain = lib.aznet_conv3x3_int8_chain
        chain.argtypes = [p, p, p, p, i, i, i, i, i, i, f, f, p, p]
        chain.restype = i
        strip = lib.aznet_conv3x3_int8_strip
        strip.argtypes = [p, p, p, p, i, i, i, i, i, i, f, f, i, p, p]
        strip.restype = i
        lib.aznet_cuda_error_string.argtypes = [i]
        lib.aznet_cuda_error_string.restype = ctypes.c_char_p
        _fns = (chain, strip, lib.aznet_cuda_error_string)
    return _fns


def _check(x, w_k, s_w, bias):
    """Validate the operands; returns (B, H, W, C, Cp, Co)."""
    tensors = (x, w_k, s_w, bias)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the int8 conv kernel takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the int8 conv operands must be on one device")
    if x.dtype != torch.int8 or w_k.dtype != torch.int8:
        raise TypeError(f"x and w_k must be int8, got {x.dtype}/{w_k.dtype}")
    if s_w.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"s_w and bias must be float32, got {s_w.dtype}/{bias.dtype}")
    if x.ndim != 4 or w_k.ndim != 3 or w_k.shape[0] != 9:
        raise ValueError(f"shapes x {tuple(x.shape)}, w_k {tuple(w_k.shape)}")
    b, h, w, c = x.shape
    co, cp = w_k.shape[1], w_k.shape[2]
    if c % 8 or co % 8:
        raise ValueError(f"the kernel takes C and Co that are multiples of 8, got {c}, {co}")
    if cp != -(-c // K_CHUNK) * K_CHUNK:
        raise ValueError(f"w_k's last dim must be C={c} rounded up to {K_CHUNK}, got {cp}")
    if s_w.shape != (co,) or bias.shape != (co,):
        raise ValueError(f"s_w {tuple(s_w.shape)} / bias {tuple(bias.shape)} vs Co={co}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the int8 conv kernel needs contiguous tensors")
    if x.data_ptr() % 8 or w_k.data_ptr() % 16:
        raise ValueError("x must be 8-byte and w_k 16-byte aligned")
    if h > 2 * 65535 or b * -(-co // 128) > 65535:
        raise ValueError(f"grid too large for x {tuple(x.shape)}, Co={co}")
    return b, h, w, c, cp, co


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
    b, h, w, c, cp, co = _check(x, w_k, s_w, bias)
    if s_out is None:
        raise ValueError("the fused pool is only for chain-interior layers (s_out given)")
    if h % 2 or w % 2:
        raise ValueError(f"the fused 2x2 pool needs even H and W, got {h}x{w}")
    out = torch.empty((b, h // 2, w // 2, co), dtype=torch.int8, device=x.device)
    chain, _, _ = _launchers()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = chain(x.data_ptr(), w_k.data_ptr(), s_w.data_ptr(), bias.data_ptr(),
                    b, h, w, c, cp, co, float(s_x), 1.0 / s_out, out.data_ptr(), stream)
    _raise_on(err, "chain")
    LAUNCHES["chain"] += 1
    return out


def conv3x3_int8_strip(x: torch.Tensor, s_x: float, w_k: torch.Tensor,
                       s_w: torch.Tensor, bias: torch.Tensor,
                       s_out: float | None = None,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Strip entry: ``x [B, H, W, C]`` int8 -> ``[B, H, W, Co]``, conv + ReLU,
    int8 at ``s_out``, or ``out_dtype`` (bf16 only) when ``s_out`` is None."""
    b, h, w, c, cp, co = _check(x, w_k, s_w, bias)
    if s_out is None and out_dtype != torch.bfloat16:
        raise TypeError(f"the kernel's float exit is bf16, got {out_dtype}")
    out = torch.empty((b, h, w, co), device=x.device,
                      dtype=torch.int8 if s_out is not None else torch.bfloat16)
    _, strip, _ = _launchers()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = strip(x.data_ptr(), w_k.data_ptr(), s_w.data_ptr(), bias.data_ptr(),
                    b, h, w, c, cp, co, float(s_x),
                    0.0 if s_out is None else 1.0 / s_out, int(s_out is None),
                    out.data_ptr(), stream)
    _raise_on(err, "strip")
    LAUNCHES["strip"] += 1
    return out
