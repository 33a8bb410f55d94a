"""The fused conv1 kernel's host side, on the CPU (the kernel itself runs only
on a card: ``tests/test_torch_cuda.py``):

- the tiled weight layouts of the bf16 and the float32 kernel
  (``ops/conv1_fused.py::kernel_layout``, ``kernel_layout_f32``) and their
  inverses, exactly;
- the persistent tile walk (``ops/cuda/conv1_kernel.py::tile_walk``, the
  kernel's order): every pooled output pixel of every card case's shape,
  and of the full 608x800 canvas, is covered exactly once, whatever the
  grid;
- the packed weights cached per parameter and per kernel dtype: reused by a
  plain forward, repacked after an in-place update or ``load_state_dict``;
- the float32 kernel's float64 yardstick (``float64_errors``) on the CPU;
- the float32 kernel's arithmetic (3xTF32 on the tensor cores, promoted
  into float32 partial sums in ``f32_promotions``' order), modelled in
  NumPy and held to that yardstick, beside a plan that keeps one
  tensor-core accumulator, which it refuses, and the same plan without the
  correction of the accumulator's truncation, which it refuses on the one
  card case where the kernel without it failed.
"""

import numpy as np
import pytest
import torch

from aznet_tpu_torch.models.vgg import VGG16Trunk
from aznet_tpu_torch.ops import conv1_fused as tconv1
from aznet_tpu_torch.ops.cuda import conv1_kernel

torch.set_num_threads(2)

# The shapes of tests/test_torch_cuda.py::CONV1_CASES (B, H, W, C), and the
# main path's b=2 608x800 canvas.
SHAPES = [(2, 64, 800, 64), (1, 34, 130, 64), (2, 64, 48, 16), (1, 6, 70, 32),
          (3, 2, 800, 64), (2, 608, 800, 64), (1, 6, 70, 8), (2, 34, 130, 24)]


@pytest.mark.parametrize("c,co", [(16, 16), (32, 32), (64, 64), (8, 8), (24, 40)])
def test_kernel_layout_round_trip(c, co):
    w12 = torch.from_numpy(np.random.RandomState(c).randn(co, c, 3, 3).astype(np.float32))
    w_k = tconv1.kernel_layout(w12)
    assert w_k.dtype == torch.bfloat16 and w_k.is_contiguous()
    assert w_k.shape == (-(-c // 16), 9, 2, 64, 8)
    assert torch.equal(tconv1.unpack_kernel_layout(w_k, c, co), w12.to(torch.bfloat16))
    # Element (chunk, tap, half, output channel, channel) is w12[o, 16*chunk + 8*half + e, dy, dx];
    # the padding (channels past C, output channels past Co) is zeros.
    o, i, dy, dx = co - 1, c - 1, 2, 1
    assert w_k[i // 16, dy * 3 + dx, (i % 16) // 8, o, i % 8] == w12[o, i, dy, dx].bfloat16()
    full = tconv1.unpack_kernel_layout(w_k, w_k.shape[0] * 16, 64).float()
    assert float(full[co:].abs().sum()) == 0 and float(full[:, c:].abs().sum()) == 0


@pytest.mark.parametrize("c,co", [(16, 16), (32, 32), (64, 64), (8, 8), (24, 40)])
def test_kernel_layout_f32_round_trip(c, co):
    """The float32 kernel's ``[9, C/8, 128, 4]``: element (tap, step, t, v)
    is thread t's ``wgmma`` A value v of the step, ``w12[o, i, dy, dx]`` with
    o = 16*(t // 32) + (t % 32)//4 + 8*(v % 2), i = 8*step + t%4 + 4*(v // 2),
    in float32; zeros past Co."""
    w12 = torch.from_numpy(np.random.RandomState(c + 1).randn(co, c, 3, 3).astype(np.float32))
    w_k = tconv1.kernel_layout_f32(w12)
    assert w_k.dtype == torch.float32 and w_k.is_contiguous() and w_k.shape == (9, c // 8, 128, 4)
    assert torch.equal(tconv1.unpack_kernel_layout_f32(w_k, co), w12)
    full = torch.nn.functional.pad(w12, (0, 0, 0, 0, 0, 0, 0, 64 - co))
    for tap, step, t, v in [(7, c // 8 - 1, 127, 3), (0, 0, 0, 0), (5, 0, 37, 1), (2, 0, 70, 2)]:
        o = 16 * (t // 32) + (t % 32) // 4 + 8 * (v % 2)
        i = 8 * step + t % 4 + 4 * (v // 2)
        assert w_k[tap, step, t, v] == full[o, i, tap // 3, tap % 3]
    assert float(tconv1.unpack_kernel_layout_f32(w_k, 64)[co:].abs().sum()) == 0
    with pytest.raises(ValueError, match="multiple of 8"):
        tconv1.kernel_layout_f32(w12[:, :c - 4])


def test_kernel_layout_rejects_wide_layers():
    with pytest.raises(ValueError, match="at most 64"):
        tconv1.kernel_layout(torch.zeros(128, 64, 3, 3))
    with pytest.raises(ValueError, match="at most 64"):
        tconv1.kernel_layout_f32(torch.zeros(64, 72, 3, 3))


@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_tile_walk_covers_every_output_once(b, h, w, c):
    tiles = conv1_kernel.num_tiles(b, h, w)
    for grid in sorted({conv1_kernel.grid_size(tiles, 132), conv1_kernel.grid_size(tiles, 7), 1}):
        walk = conv1_kernel.tile_walk(b, h, w, grid)
        seen = np.zeros((b, h // 2, w // 2), np.int32)
        for (block, wg), mine in walk.items():
            assert 0 <= block < grid and wg in (0, 1)
            for img, pair, seg in mine:
                seen[img, pair, seg * 64:seg * 64 + 64] += 1
        assert (seen == 1).all(), (grid, np.unique(seen))
        assert sum(len(v) for v in walk.values()) == tiles
        for block in range(grid):  # the two warpgroups of a block take turns
            assert 0 <= len(walk.get((block, 0), [])) - len(walk.get((block, 1), [])) <= 1


@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_tile_walk_f32_covers_every_output_once(b, h, w, c):
    """The float32 kernel's walk: 64-column segments, the same order."""
    cols = conv1_kernel.TILE_COLS_F32
    tiles = conv1_kernel.num_tiles(b, h, w, cols)
    for grid in sorted({conv1_kernel.grid_size(tiles, 132), conv1_kernel.grid_size(tiles, 7), 1}):
        seen = np.zeros((b, h // 2, w // 2), np.int32)
        walk = conv1_kernel.tile_walk(b, h, w, grid, cols)
        for mine in walk.values():
            for img, pair, seg in mine:
                seen[img, pair, seg * cols // 2:(seg + 1) * cols // 2] += 1
        assert (seen == 1).all(), (grid, np.unique(seen))
        assert sum(len(v) for v in walk.values()) == tiles


@pytest.mark.parametrize("c", [8, 16, 24, 64])
def test_f32_promotions(c):
    """Every (tap, k8 step) once; dy's taps only in dy's groups; a group is
    one tap's steps of a 16-channel chunk (two, or one where C ends in the
    chunk's first half), taps dx = 0, 1, 2 in turn; the correction on every
    two-step group and on a one-step group's dx = 2."""
    plan = conv1_kernel.f32_promotions(c)
    assert len(plan) == 3
    flat = [ts for groups in plan for g, _ in groups for ts in g]
    assert sorted(flat) == [(tap, s) for tap in range(9) for s in range(c // 8)]
    steps = c // 8
    for dy, groups in enumerate(plan):
        assert len(groups) == 3 * -(-steps // 2)
        for n, (g, unbias) in enumerate(groups):
            i, dx = divmod(n, 3)
            assert g == [(3 * dy + dx, s) for s in range(2 * i, min(2 * i + 2, steps))]
            assert unbias == (len(g) == 2 or dx == 2)


def test_grid_size():
    assert conv1_kernel.grid_size(4256, 132) == 132  # b=2 on the 608x800 canvas
    assert conv1_kernel.grid_size(21, 132) == 11  # b=3, 2x800: not a multiple of the grid
    assert conv1_kernel.grid_size(1, 132) == 1


def test_packed_weights_follow_updates():
    torch.manual_seed(0)
    trunk = VGG16Trunk(width=0.25)
    w = trunk.conv1_2.weight
    first = tconv1.packed_weights(w)
    assert tconv1.packed_weights(w) is first  # a plain forward does not repack
    with torch.no_grad():
        w.mul_(2.0)  # in place: the version counter moves
    second = tconv1.packed_weights(w)
    assert second is not first
    assert torch.equal(tconv1.unpack_kernel_layout(second, 16, 16), w.detach().bfloat16())
    state = {k: v * 0.5 for k, v in trunk.state_dict().items()}
    trunk.load_state_dict(state)
    third = tconv1.packed_weights(trunk.conv1_2.weight)
    assert torch.equal(tconv1.unpack_kernel_layout(third, 16, 16),
                       state["conv1_2.weight"].bfloat16())
    with torch.inference_mode():
        assert tconv1.packed_weights(trunk.conv1_2.weight) is third


def test_packed_weights_follow_updates_f32():
    """A float32 trunk's conv1_2: the float32 layout is cached beside the
    bf16 one, each reused by a plain forward and repacked after an update."""
    torch.manual_seed(1)
    trunk = VGG16Trunk(width=0.25)
    w = trunk.conv1_2.weight
    first = tconv1.packed_weights(w, torch.float32)
    bf16 = tconv1.packed_weights(w)
    assert first.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert tconv1.packed_weights(w, torch.float32) is first
    assert tconv1.packed_weights(w) is bf16
    assert torch.equal(tconv1.unpack_kernel_layout_f32(first, 16), w.detach())
    with torch.no_grad():
        w.add_(1.0)
    second = tconv1.packed_weights(w, torch.float32)
    assert second is not first
    assert torch.equal(tconv1.unpack_kernel_layout_f32(second, 16), w.detach())
    state = {k: v * 0.5 for k, v in trunk.state_dict().items()}
    trunk.load_state_dict(state)
    third = tconv1.packed_weights(trunk.conv1_2.weight, torch.float32)
    assert torch.equal(tconv1.unpack_kernel_layout_f32(third, 16), state["conv1_2.weight"])
    with torch.inference_mode():
        assert tconv1.packed_weights(trunk.conv1_2.weight, torch.float32) is third


def test_float64_errors():
    """The plain version in float64 agrees with itself, and holds the plain
    float32 version to its own error; a kernel output off by more than
    1e-5 of the largest value fails."""
    rng = np.random.RandomState(2)
    y = torch.from_numpy(np.maximum(rng.randn(1, 8, 10, 16), 0).astype(np.float32) * 40)
    w12 = torch.from_numpy((rng.randn(16, 16, 3, 3) * 0.05).astype(np.float32))
    b12 = torch.from_numpy(rng.uniform(-1, 1, 16).astype(np.float32))
    exact = tconv1.conv1_2_pool_reference(y.double(), w12.double(), b12.double())
    assert exact.dtype == torch.float64
    plain = tconv1.conv1_2_pool_reference(y, w12, b12)
    ok, errs = tconv1.float64_errors(plain, y, w12, b12)
    assert ok and errs["kernel"] == errs["plain"] and errs["rel"] == 0
    assert errs["plain"] <= 1e-5 * float(exact.abs().max())
    off = plain.clone()
    off[0, 0, 0, 0] += 1e-4 * float(plain.abs().max())
    assert not tconv1.float64_errors(off, y, w12, b12)[0]


# The float32 kernel's arithmetic, modelled in NumPy: the operands split
# into TF32 hi and lo by cvt.rna (round to nearest, ties away from zero, on
# the 13 low bits), each k8 step's three products lo_w.hi_y, hi_w.lo_y,
# hi_w.hi_y as exact 8-term sums, the tensor core's f32 accumulator rounded
# toward zero after each (NVIDIA does not document its rounding; the H100
# truncates), and the promotions in float32 rounded to nearest once.


def _tf32_rna(x):
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_tf32(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)  # x - hi is exact in float32


def _toward_zero(x):
    """float64 -> float32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def model_f32_kernel(y, w12, b12, plan):
    """The output of the float32 kernel's arithmetic on NumPy ``y [B, H, W,
    C]``, ``w12 [Co, C, 3, 3]``, ``b12 [Co]`` under ``plan``: ``"kernel"``
    (``f32_promotions``), ``"no_unbias"`` (the same without the correction)
    or ``"one_accumulator"`` (every tap and step in one tensor-core
    accumulator, no promotion)."""
    bsz, h, w, c = y.shape
    y_hi, y_lo = _split_tf32(np.pad(y, ((0, 0), (1, 1), (1, 1), (0, 0))))
    w_hi, w_lo = _split_tf32(w12.transpose(2, 3, 1, 0).reshape(9, c, -1))

    def step(acc, tap, s):
        dy, dx = divmod(tap, 3)
        ch = slice(8 * s, 8 * s + 8)
        for wp, yp in ((w_lo, y_hi), (w_hi, y_lo), (w_hi, y_hi)):
            blk = yp[:, dy:dy + h, dx:dx + w, ch].astype(np.float64) @ wp[tap, ch].astype(
                np.float64)
            acc = _toward_zero(blk if acc is None else acc.astype(np.float64) + blk)
        return acc

    if plan != "one_accumulator":
        tot = np.float32(0)
        for groups in conv1_kernel.f32_promotions(c):
            part = np.float32(0)
            for g, unbias in groups:
                acc = None
                for tap, s in g:
                    acc = step(acc, tap, s)
                if unbias and plan == "kernel":  # fma(acc, 1 + 2^-23, part): one rounding
                    part = (acc.astype(np.float64) * (1 + 2.0 ** -23) + part).astype(np.float32)
                else:
                    part = part + acc  # float32, round to nearest
            tot = tot + part
    else:
        tot = None
        for tap in range(9):
            for s in range(c // 8):
                tot = step(tot, tap, s)
    pooled = tot.reshape(bsz, h // 2, 2, w // 2, 2, -1).max(axis=(2, 4))
    return np.maximum(pooled + b12, np.float32(0))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("plan", ["kernel", "one_accumulator"])
def test_f32_kernel_arithmetic_float64_gate(plan, seed):
    """At C = Co = 64 on a 1x16x32 map (ReLU'd activations x 40, He-scaled
    weights), the kernel's plan meets ``float64_errors`` (at most twice the
    plain float32 version's error against float64, and 1e-5 of max|plain|);
    one accumulator truncating over all 216 products does not, so the gate
    tells the two apart."""
    rng = np.random.RandomState(seed)
    y = (np.maximum(rng.randn(1, 16, 32, 64), 0) * 40).astype(np.float32)
    w12 = (rng.randn(64, 64, 3, 3) * np.sqrt(2 / (9 * 64))).astype(np.float32)
    b12 = rng.uniform(-1, 1, 64).astype(np.float32)
    got = torch.from_numpy(model_f32_kernel(y, w12, b12, plan))
    ok, errs = tconv1.float64_errors(got, *map(torch.from_numpy, (y, w12, b12)))
    assert ok == (plan == "kernel"), errs


def test_f32_truncation_correction():
    """The card test ``test_conv1_f32_kernel_narrow_shapes[16-8-3]``'s data
    (3 x 2 x 70 x 16 -> 8): without the correction the model's error is
    2.13 times the plain version's, as a kernel without it (promoting every
    step) did on an H100; with it the gate holds."""
    rng = np.random.RandomState(16 + 8 + 3)
    y = np.maximum(rng.randn(3, 2, 70, 16), 0).astype(np.float32) * 40
    w12 = (rng.randn(8, 16, 3, 3) * 0.05).astype(np.float32)
    b12 = rng.uniform(-1, 1, 8).astype(np.float32)
    args = [torch.from_numpy(a) for a in (y, w12, b12)]
    ok, errs = tconv1.float64_errors(torch.from_numpy(model_f32_kernel(y, w12, b12, "kernel")),
                                     *args)
    assert ok, errs
    ok, errs = tconv1.float64_errors(
        torch.from_numpy(model_f32_kernel(y, w12, b12, "no_unbias")), *args)
    assert not ok and errs["kernel"] > 2 * errs["plain"], errs
