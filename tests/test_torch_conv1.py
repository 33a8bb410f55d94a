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
- the float32 kernel's float64 yardstick (``float64_errors``) on the CPU.
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
    """The float32 kernel's ``[9, C, 64]``: element (tap, c, o) is
    ``w12[o, c, dy, dx]`` in float32, zeros past Co."""
    w12 = torch.from_numpy(np.random.RandomState(c + 1).randn(co, c, 3, 3).astype(np.float32))
    w_k = tconv1.kernel_layout_f32(w12)
    assert w_k.dtype == torch.float32 and w_k.is_contiguous() and w_k.shape == (9, c, 64)
    assert torch.equal(tconv1.unpack_kernel_layout_f32(w_k, co), w12)
    o, i, dy, dx = co - 1, c - 1, 2, 1
    assert w_k[dy * 3 + dx, i, o] == w12[o, i, dy, dx]
    assert float(w_k[:, :, co:].abs().sum()) == 0


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
