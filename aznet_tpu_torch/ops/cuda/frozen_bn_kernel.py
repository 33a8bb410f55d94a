"""Frozen BatchNorm's epilogue on the card: wrapper of
``aznet_tpu_torch/csrc/frozen_bn.cu``.

Replaces no TPU kernel (XLA fuses the JAX package's ``FrozenBN`` into its
convolutions): after each convolution of the ResNet trunk, the per-channel
affine, the residual add (the block input, or the downsample's output
through its own affine) and the ReLU in one pass that writes into the
convolution's output. It is bound by bytes.

Only CUDA tensors are accepted; the plain PyTorch version is
``aznet_tpu_torch.ops.frozen_bn.frozen_bn_relu_reference``, equal bit for
bit, and the dispatch is ``ops/frozen_bn.py::frozen_bn_relu``. The host side
is kept to metadata checks and one ctypes call (no synchronisation): the
trunk's 40 launches a call have to stay ahead of the card.
"""

from __future__ import annotations

import ctypes

import torch

from aznet_tpu_torch.ops.cuda import sm_count

DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_CL = torch.channels_last
INVALID_VALUE = 1  # cudaErrorInvalidValue: what the C entry refuses

# Launches of the kernel (one per call that reaches the card).
LAUNCHES = 0

_fns = None


def _launcher():
    global _fns
    if _fns is None:
        from aznet_tpu_torch import _build

        lib = _build.load()
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = lib.aznet_frozen_bn_launch
        fn.argtypes = [i, i, p, p, p, p, p, p, q, i, i, p]
        fn.restype = i
        lib.aznet_cuda_error_string.argtypes = [i]
        lib.aznet_cuda_error_string.restype = ctypes.c_char_p
        _fns = (fn, lib.aznet_cuda_error_string)
    return _fns


def _refusal(y, s, b, r, sr, br) -> str:
    """Why the arguments are refused (the checks of :func:`frozen_bn_relu_cuda`
    again, one argument at a time, for the message)."""
    c = y.shape[1]
    for t, shape, what in ((y, y.shape, "y"), (s, (c,), "s"), (b, (c,), "b"), (r, y.shape, "r"),
                           (sr, (c,), "sr"), (br, (c,), "br")):
        if t is None:
            continue
        if t.device != y.device or t.dtype != y.dtype or t.shape != shape:
            return (f"{what}: {t.dtype} {tuple(t.shape)} on {t.device}, expected {y.dtype} "
                    f"{tuple(shape)} on {y.device}")
        if not t.is_contiguous(memory_format=_CL if t.ndim == 4 else torch.contiguous_format):
            return f"{what} must be {'channels-last' if t.ndim == 4 else 'contiguous'}"
    return "an argument does not start on 16 bytes"  # the C entry's remaining check


def frozen_bn_relu_cuda(y: torch.Tensor, s: torch.Tensor, b: torch.Tensor,
                        r: torch.Tensor | None = None, sr: torch.Tensor | None = None,
                        br: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(y * s + b)``, with ``r`` (or ``r * sr + br``) added before the
    ReLU, per channel of the NCHW ``y [N, C, H, W]`` in channels-last memory,
    rounded as PyTorch's separate operations round: written into ``y``,
    which is returned. ``r`` as ``y``; ``s``, ``b``, ``sr``, ``br`` ``[C]``;
    one dtype (bf16 or float32) and one CUDA device; C a multiple of 8;
    every tensor starting on 16 bytes. Raises on anything else. The checks
    read metadata alone, at a few microseconds a call."""
    global LAUNCHES
    dt, dev, shape = y.dtype, y.device, y.shape
    if not y.is_cuda:
        raise ValueError(f"frozen_bn_relu_cuda takes CUDA tensors, got {dev}")
    code = DTYPES.get(dt)
    if code is None:
        raise TypeError(f"frozen_bn_relu_cuda takes bf16 or float32, got {dt}")
    c = shape[1] if len(shape) == 4 else 0
    if c < 8 or c % 8:
        raise ValueError(f"y [N, C, H, W] with C a multiple of 8, got {tuple(shape)}")
    if (sr is None) != (br is None) or (sr is not None and r is None):
        raise ValueError("sr and br come together, with r")
    chan = (c,)
    ok = y.is_contiguous(memory_format=_CL)
    if r is not None:
        ok = ok and (r.dtype == dt and r.device == dev and r.shape == shape
                     and r.is_contiguous(memory_format=_CL))
    for t in (s, b) if sr is None else (s, b, sr, br):
        ok = ok and t.dtype == dt and t.device == dev and t.shape == chan and t.is_contiguous()
    if not ok:
        raise ValueError(_refusal(y, s, b, r, sr, br))
    rows = y.numel() // c
    if rows == 0:
        return y
    fn, err_str = _launcher()
    idx = dev.index
    args = (code, 0 if r is None else 1 if sr is None else 2, y.data_ptr(),
            None if r is None else r.data_ptr(), s.data_ptr(), b.data_ptr(),
            None if sr is None else sr.data_ptr(), None if br is None else br.data_ptr(),
            rows, c, sm_count(idx), torch._C._cuda_getCurrentRawStream(idx))
    if idx == torch._C._cuda_getDevice():
        err = fn(*args)
    else:  # the launch goes to the current device's context
        with torch.cuda.device(idx):
            err = fn(*args)
    if err == INVALID_VALUE:  # the C side checks the alignment
        raise ValueError(_refusal(y, s, b, r, sr, br))
    if err != 0:
        raise RuntimeError(f"frozen BatchNorm kernel launch failed: {err_str(err).decode()} "
                           f"({err})")
    LAUNCHES += 1
    return y
