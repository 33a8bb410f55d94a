"""Port parity, the IoU matrix: the plain ``ops/iou.py::bbox_overlaps`` (the
plain version of the CUDA kernel ``csrc/iou.cu``) against the JAX package's
``bbox_overlaps`` and its Pallas kernel ``bbox_overlaps_pallas`` in
interpret mode, at ``tests/test_pallas.py``'s and ``check_iou``'s shapes,
with degenerate, zero-area and union <= 0 boxes; and against the kernel's
own order of float32 steps written out in NumPy.

Tolerances: bit-exact against the NumPy steps and against JAX's
``bbox_overlaps``. Against the Pallas kernel in interpret mode, at most 4
float32 ulps on at most 1% of the elements: XLA's compiled tile rounds some
steps differently on the CPU (measured: up to 3 ulps on 0.4-0.5% of the
elements at these shapes)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aznet_tpu.ops.iou import bbox_overlaps as jbbox_overlaps
from aznet_tpu.ops.pallas.iou_kernel import bbox_overlaps_pallas
from aznet_tpu_torch.ops.cuda import iou_kernel
from aznet_tpu_torch.ops.iou import bbox_overlaps

torch.set_num_threads(1)

# (N, K): test_pallas's three, check_iou's, ragged tiles.
CASES = [(50, 40), (128, 128), (200, 300), (300, 200), (7, 129), (33, 1)]


def _inputs(seed, n, k):
    """Boxes in [0, 1000] plus wh in [0, 200], one box in 16 of each side
    degenerate; row 0 with a negative area (union < 0 with every column),
    row 1 and column 0 with zero area (union 0 between them)."""
    rng = np.random.RandomState(seed)
    out = []
    for m in (n, k):
        xy = rng.uniform(0, 1000, (m, 2))
        wh = rng.uniform(0, 200, (m, 2))
        bad = rng.rand(m) < 1 / 16
        wh[bad] = rng.choice([-1.0, -0.5, -30.0], (int(bad.sum()), 2))
        out.append(np.concatenate([xy, xy + wh], 1).astype(np.float32))
    out[0][0] = [0.0, 500.0, 1000.0, 0.0]
    if n > 1:
        out[0][1] = [500.0, 500.0, 499.0, 499.0]
    out[1][0] = [10.0, 10.0, 9.0, 9.0]
    return out


def _ulps(a, b):
    """Distance in float32 ulps (both finite, same sign or zero)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def _kernel_steps(a, b, off, skip_disjoint=True):
    """``csrc/iou.cu``'s float32 steps in its order, in NumPy. With
    ``skip_disjoint`` as the kernel does: where iw <= 0 or ih <= 0 the pair
    gets +0 with no product, union or division; without it, the plain
    version's steps (clamp both sides, divide wherever the union is > 0)."""
    f = np.float32
    off = f(off)
    r, c = a[:, None, :], b[None, :, :]
    iw = (np.minimum(r[..., 2], c[..., 2]) - np.maximum(r[..., 0], c[..., 0])) + off
    ih = (np.minimum(r[..., 3], c[..., 3]) - np.maximum(r[..., 1], c[..., 1])) + off
    overlap = (iw > 0) & (ih > 0)
    inter = iw * ih if skip_disjoint else np.maximum(iw, f(0)) * np.maximum(ih, f(0))
    area_r = ((a[:, 2] - a[:, 0]) + off) * ((a[:, 3] - a[:, 1]) + off)
    area_c = ((b[:, 2] - b[:, 0]) + off) * ((b[:, 3] - b[:, 1]) + off)
    uni = (area_r[:, None] + area_c[None, :]) - inter
    divide = (uni > 0) & overlap if skip_disjoint else uni > 0
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        return np.where(divide, inter / uni, f(0)).astype(np.float32)


@pytest.mark.parametrize("n,k", CASES)
@pytest.mark.parametrize("offset", [1.0, 0.0])
def test_bbox_overlaps_matches_jax(n, k, offset):
    a, b = _inputs(n * 7 + k, n, k)
    got = bbox_overlaps(torch.from_numpy(a), torch.from_numpy(b), offset).numpy()
    assert got.dtype == np.float32 and got.shape == (n, k)
    np.testing.assert_array_equal(got, _kernel_steps(a, b, offset))
    assert (got[0] == 0).all()  # union < 0
    np.testing.assert_array_equal(
        got, np.asarray(jbbox_overlaps(jnp.asarray(a), jnp.asarray(b), offset)))
    pallas = np.asarray(bbox_overlaps_pallas(jnp.asarray(a), jnp.asarray(b), offset,
                                             interpret=True))
    share = float((got != pallas).mean())
    assert _ulps(got, pallas) <= 4 and share <= 0.01, (_ulps(got, pallas), share)


@pytest.mark.parametrize("offset", [1.0, 0.0])
def test_skipping_disjoint_divisions_keeps_the_bits(offset):
    """The kernel writes +0 for iw <= 0 or ih <= 0 without dividing: the
    same bits as dividing +0 by the union (+0, never -0), at random boxes
    and at pairs that touch, share an edge at offset 0, nest, or are
    disjoint in one axis only, and where the product underflows."""
    a, b = _inputs(11, 300, 200)
    extra = np.array([[0, 0, 10, 10], [10, 0, 20, 10], [0, 10, 10, 20], [2, 2, 8, 8],
                      [0, 50, 10, 60], [100, 0, 110, 10], [0, 0, 1e-30, 1e-30],
                      [-5, -5, -1, -1]], np.float32)
    a, b = np.concatenate([a, extra]), np.concatenate([b, extra])
    skip = _kernel_steps(a, b, offset)
    whole = _kernel_steps(a, b, offset, skip_disjoint=False)
    np.testing.assert_array_equal(skip.view(np.int32), whole.view(np.int32))
    assert not np.signbit(skip).any()
    assert (skip == 0).mean() > 0.5 and (skip > 0).any()


# (N, K) of the tile-walk coverage test: K % 4 in {0, 1, 2, 3}, N = 1, K = 1,
# shares that end inside a tile, N above the old 65,535 x 32 row cap.
WALK_CASES = [(300, 200), (300, 201), (50, 41), (129, 130), (2047, 2049), (4096, 4095),
              (1, 1), (1, 4096), (37, 3), (1000, 129), (2_100_000, 3)]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("n,k", WALK_CASES)
def test_tile_walk_writes_every_pair_once(n, k, sms):
    """Walks the launch the wrapper plans (``launch_plan``) through the
    kernel's index arithmetic (``warp_rows``, ``lane_columns``) over every
    warp of the grid: each (i, j) of ``[N, K]`` is written exactly once,
    nothing outside it; the warps' shares differ by at most one row; the
    vector body's lanes hold 4 live columns or none, each store on 16
    bytes."""
    plan = iou_kernel.launch_plan(n, k, sms)
    blocks, share, extra = plan
    warps = 1 if share == 0 else iou_kernel.WARPS
    # What the C entry checks before it launches.
    slices = -(-k // iou_kernel.TILE_COLS) * n
    assert slices == (blocks if share == 0 else share * blocks * warps + extra)
    assert 0 <= extra < blocks * warps
    count = np.zeros((n, k), np.uint8)
    shares = []
    for block, w in np.ndindex(blocks, warps):
        rows = 0
        for r0, r1, c0 in iou_kernel.warp_rows(n, plan, block, w):
            assert 0 <= r0 < r1 <= n and 0 <= c0 < k and c0 % iou_kernel.TILE_COLS == 0
            cols = iou_kernel.lane_columns(k, c0)
            live = cols[cols >= 0]
            assert live.max() < k and len(np.unique(live)) == len(live)
            if k % 4 == 0:
                assert ((cols >= 0).all(1) | (cols < 0).all(1)).all()
                assert (cols[cols[:, 0] >= 0, 0] % 4 == 0).all()  # (i * K + j) * 4 on 16 bytes
            count[r0:r1, live] += 1
            rows += r1 - r0
        shares.append(rows)
    assert (count == 1).all()
    assert max(shares) - min(shares) <= 1


@pytest.mark.parametrize("n", [1, 3, 16385, iou_kernel.INDEX32_MAX // 128])
def test_32bit_indices_stay_below_2_31(n):
    """At the largest N * K that takes 32-bit indices, the largest values the
    kernel forms in them stay below 2^31: a lane's last column (the last tile
    ends at ``tiles * 128 - 1`` in both bodies), the last row's offset plus
    that column, and K plus a tile (the tile count)."""
    k = iou_kernel.INDEX32_MAX // n
    assert n * k <= iou_kernel.INDEX32_MAX < n * (k + 1)
    tiles = -(-k // iou_kernel.TILE_COLS)
    last = tiles * iou_kernel.TILE_COLS - 1
    for wider in (4, 5):  # the element-wise body's lanes, then the vector body's, unmasked
        assert iou_kernel.lane_columns(last + wider, last + 1 - iou_kernel.TILE_COLS).max() == last
    assert max((n - 1) * k + last, k + iou_kernel.TILE_COLS - 1) <= 2**31 - 1


def test_launch_plan_fills_the_card():
    """Four persistent blocks of 8 warps per SM where the slices outnumber
    the warps, so 2048 x 2048 fills 132 SMs too; otherwise one 1-warp block
    a slice, block b on row b % N of tile b // N."""
    full = 132 * iou_kernel.BLOCKS_PER_SM
    warps = full * iou_kernel.WARPS
    assert iou_kernel.launch_plan(4096, 4096, 132) == (full, *divmod(32 * 4096, warps))
    assert iou_kernel.launch_plan(2048, 2048, 132) == (full, *divmod(16 * 2048, warps))
    assert iou_kernel.launch_plan(2_100_000, 3, 132) == (full, *divmod(2_100_000, warps))
    assert iou_kernel.launch_plan(4096, 4096, 1) == (iou_kernel.BLOCKS_PER_SM, 4096, 0)
    assert iou_kernel.launch_plan(300, 200, 132) == (600, 0, 0)  # 2 tiles x 300 rows
    assert iou_kernel.launch_plan(1, 4096, 132) == (32, 0, 0)
    assert iou_kernel.launch_plan(1, 1, 132) == (1, 0, 0)
    assert list(iou_kernel.warp_rows(300, (600, 0, 0), 301, 0)) == [(1, 2, 128)]
    for block in range(32):
        assert list(iou_kernel.warp_rows(1, (32, 0, 0), block, 0)) == [(0, 1, block * 128)]


def test_bbox_overlaps_cuda_rejects_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only: nothing falls back."""
    a = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        iou_kernel.bbox_overlaps_cuda(a, a)
