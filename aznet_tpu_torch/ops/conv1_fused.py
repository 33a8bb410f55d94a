"""VGG-16's conv1 block fused (``MODEL.FUSE_CONV1``): counterpart of
``aznet_tpu/ops/pallas/conv1_kernel.py::fused_conv1_pool``.

conv1_1 runs as a plain convolution in the input's dtype with no bias in
the conv, then ``+ b11`` in that dtype and ReLU (the reference's order, which
rounds twice in bf16). conv1_2, its f32 bias, ReLU and the 2x2/2 max-pool
then run as one step: for a CUDA tensor the CUDA kernel of the input's
dtype (``ops/cuda/conv1_kernel.py``: bf16 on the tensor cores, float32 as
three TF32 products on the tensor cores held to float32's error), for a CPU
tensor :func:`conv1_2_pool_reference`. Weights are
the trunk's own, OIHW; activations NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aznet_tpu_torch.ops.conv_int8 import max_pool_2x2
from aznet_tpu_torch.ops.cuda import conv1_kernel
from aznet_tpu_torch.utils.precision import float32_precision


def conv1_1_relu(x: torch.Tensor, w11: torch.Tensor, b11: torch.Tensor) -> torch.Tensor:
    """``relu(conv(x, w11) + b11)`` in ``x``'s dtype, NHWC in and out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w11.to(x.dtype), padding=1).permute(0, 2, 3, 1)
    return torch.relu(y + b11.to(x.dtype))


@float32_precision()
def conv1_2_pool_reference(y: torch.Tensor, w12: torch.Tensor, b12: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernels: ``y [B, H, W, C]`` -> ``[B, H/2,
    W/2, Co]`` in ``y``'s dtype. Nine f32 tap matmuls on the values of ``y``
    and ``w12`` (OIHW), summed in tap order, ``+ b12`` in f32, ReLU, the 2x2
    max-pool, one rounding to ``y``'s dtype. A float64 ``y`` computes all of
    it in float64 (the float32 kernel's yardstick, :func:`float64_errors`)."""
    b, h, w, c = y.shape
    dt = torch.float64 if y.dtype == torch.float64 else torch.float32
    yp = F.pad(y.to(dt), (0, 0, 1, 1, 1, 1))
    wf = w12.to(dt)
    acc = None
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        d = yp[:, dy:dy + h, dx:dx + w] @ wf[:, :, dy, dx].t()
        acc = d if acc is None else acc + d
    return max_pool_2x2(torch.relu(acc + b12.to(dt))).to(y.dtype)


def within_one_bf16_ulp(got: torch.Tensor, want: torch.Tensor):
    """The kernel's tolerance against its plain version: every element
    within one bf16 ulp of the larger of the two values, or within
    ``1e-5 * max|want|`` (values near zero after the ReLU). Returns (ok, the
    share of elements that differ)."""
    got, want = got.float(), want.float()
    _, exp = torch.frexp(torch.maximum(got.abs(), want.abs()))
    ulp = torch.ldexp(torch.ones_like(got), exp - 8)  # 2**(floor(log2|v|) - 7)
    floor = 1e-5 * want.abs().max()
    diff = (got - want).abs()
    ok = bool((diff <= torch.maximum(ulp, floor)).all())
    return ok, (diff > 0).float().mean().item()


def float64_errors(got: torch.Tensor, y: torch.Tensor, w12: torch.Tensor, b12: torch.Tensor):
    """The float32 kernel's tolerance. Its output ``got`` and the plain
    version on ``(y, w12, b12)``, each against the plain version in float64
    on the same operands: the kernel sums in another order than the plain
    version, so it is held to at most twice the plain version's largest
    error, and to ``max|got - plain| <= 1e-5 * max|plain|``. Returns (ok,
    {"kernel": its largest error, "plain": the plain version's, "rel":
    max|got - plain| / max|plain|})."""
    plain = conv1_2_pool_reference(y, w12, b12).double()
    exact = conv1_2_pool_reference(y.double(), w12.double(), b12.double())
    got = got.double()
    errs = {"kernel": (got - exact).abs().max().item(),
            "plain": (plain - exact).abs().max().item(),
            "rel": ((got - plain).abs().max() / plain.abs().max()).item()}
    return errs["kernel"] <= 2 * errs["plain"] and errs["rel"] <= 1e-5, errs


def kernel_layout(w12: torch.Tensor) -> torch.Tensor:
    """OIHW ``[Co, C, 3, 3]`` -> the kernel's tiled bf16 ``[Cp/16, 9, 2, 64,
    8]``: 16-channel chunk, tap (dy*3 + dx), 8-channel half, output channel
    (zero-padded to 64, the wgmma M), channel; Cp is C rounded up to 16, the
    padding zeros. Each chunk's taps are the wgmma A operand's no-swizzle
    core matrices, and the whole tensor is one bulk copy."""
    co, c = w12.shape[:2]
    if co > 64 or c > 64:
        raise ValueError(f"the fused conv1 layout holds at most 64 channels, got {c}->{co}")
    cp = -(-c // 16) * 16
    w = F.pad(w12.to(torch.bfloat16), (0, 0, 0, 0, 0, cp - c, 0, 64 - co))  # [64, Cp, 3, 3]
    return w.reshape(64, cp // 16, 2, 8, 9).permute(1, 4, 2, 0, 3).contiguous()


def unpack_kernel_layout(w_k: torch.Tensor, c: int, co: int) -> torch.Tensor:
    """Inverse of :func:`kernel_layout`: the OIHW ``[Co, C, 3, 3]`` weights."""
    return w_k.permute(3, 0, 2, 4, 1).reshape(64, w_k.shape[0] * 16, 3, 3)[:co, :c]


def kernel_layout_f32(w12: torch.Tensor) -> torch.Tensor:
    """OIHW ``[Co, C, 3, 3]`` -> the float32 kernel's ``[9, C/8, 128, 4]``:
    tap (dy*3 + dx), k8 step (8 input channels), consumer thread t of the
    warpgroup, value v: thread t's ``wgmma`` A fragment of the step, one
    16-byte word. With warp ``t // 32`` and lane ``l = t % 32``, value v is
    output channel ``16*(t // 32) + l//4 + 8*(v % 2)`` and input channel
    ``8*step + l%4 + 4*(v // 2)``; output channels past Co are zeros. C must
    be a multiple of 8."""
    co, c = w12.shape[:2]
    if co > 64 or c > 64:
        raise ValueError(f"the fused conv1 layout holds at most 64 channels, got {c}->{co}")
    if c % 8:
        raise ValueError(f"the float32 fused conv1 layout needs C a multiple of 8, got {c}")
    w = F.pad(w12.float(), (0, 0, 0, 0, 0, 0, 0, 64 - co))  # [64, C, 3, 3]
    # [tap, step, v//2, l%4, warp, v%2, l//4] -> [tap, step, warp, l//4, l%4, v//2, v%2]
    w = w.permute(2, 3, 1, 0).reshape(9, c // 8, 2, 4, 4, 2, 8)
    return w.permute(0, 1, 4, 6, 3, 2, 5).reshape(9, c // 8, 128, 4).contiguous()


def unpack_kernel_layout_f32(w_k: torch.Tensor, co: int) -> torch.Tensor:
    """Inverse of :func:`kernel_layout_f32`: the OIHW ``[Co, C, 3, 3]`` weights."""
    steps = w_k.shape[1]
    w = w_k.reshape(9, steps, 4, 8, 4, 2, 2).permute(0, 1, 5, 4, 2, 6, 3)
    return w.reshape(3, 3, steps * 8, 64)[..., :co].permute(3, 2, 0, 1)


def packed_weights(w12: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel layout of ``w12`` for the kernel of ``dtype``
    (:func:`kernel_layout_f32` for float32, else :func:`kernel_layout`),
    cached on the tensor per dtype and keyed on its storage and version
    counter, so an in-place update (``load_state_dict``, an optimizer step)
    or a new storage repacks it and a plain forward does not."""
    layout = kernel_layout_f32 if dtype == torch.float32 else kernel_layout
    if w12.is_inference():  # no version counter to key on
        return layout(w12.detach())
    key = (w12.data_ptr(), w12._version, w12.dtype, tuple(w12.shape))
    cache = getattr(w12, "_conv1_kernel_layouts", None)
    if cache is None:
        cache = w12._conv1_kernel_layouts = {}
    if layout not in cache or cache[layout][0] != key:
        cache[layout] = (key, layout(w12.detach()))
    return cache[layout][1]


def fused_conv1_pool(x: torch.Tensor, w11: torch.Tensor, b11: torch.Tensor,
                     w12: torch.Tensor, b12: torch.Tensor) -> torch.Tensor:
    """conv1_1 -> ReLU -> conv1_2 -> ReLU -> 2x2 max-pool: ``x [B, H, W, 3]``
    -> ``[B, H/2, W/2, C]`` in ``x``'s dtype. On the card the kernels take bf16
    or float32, with C and Co multiples of 8 up to 64."""
    y = conv1_1_relu(x, w11, b11)
    if y.is_cuda:
        entry = (conv1_kernel.conv1_2_pool_cuda_f32 if y.dtype == torch.float32
                 else conv1_kernel.conv1_2_pool_cuda)
        return entry(y.contiguous(), packed_weights(w12, y.dtype), b12.float().contiguous())
    if y.device.type != "cpu":
        raise ValueError(f"no fused conv1 for device {y.device}")
    return conv1_2_pool_reference(y, w12, b12)
