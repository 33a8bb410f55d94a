"""Port parity, NMS: the plain PyTorch keep masks equal the reference's
EXACTLY (no tolerance: a keep set is discrete).

Held against the Pallas kernel in interpret mode (bitonic order, tile 128),
the reference's fixpoint ``nms_mask`` and the host greedy ``nms``. The CUDA
kernel is held against the plain version on a card by
``tests/test_torch_cuda.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aznet_tpu.ops.pallas.nms_kernel import nms_pallas_batched
from aznet_tpu_torch.ops import nms as tnms
from aznet_tpu_torch.ops.cuda import nms_kernel
from aznet_tpu_torch.ops.topk import top_k

# aznet_tpu.ops re-exports a function named nms over the module's name.
jnms = importlib.import_module("aznet_tpu.ops.nms")

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _case(seed, bsz, n, ties=8, extent=300.0):
    """Overlapping boxes; tie-heavy scores with +-0 and subnormal rows; ~10%
    invalid rows (never a valid row with a -inf score)."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, extent, (bsz, n, 2)).astype(np.float32)
    wh = rng.uniform(5, 150, (bsz, n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = (np.floor(rng.rand(bsz, n) * ties) / ties).astype(np.float32)
    scores[0, : n // 8] = -0.0
    scores[0, n // 8: n // 6] = np.float32(1e-40)  # subnormal: ties with 0
    scores[0, n // 6: n // 5] = np.float32(-3e-39)
    valid = rng.rand(bsz, n) > 0.1
    return boxes, scores, valid


def _plain(boxes, scores, valid, thresh, offset=1.0):
    return tnms.nms_mask_batched(torch.from_numpy(boxes), torch.from_numpy(scores), thresh,
                                 torch.from_numpy(valid), offset).numpy()


@pytest.mark.parametrize("bsz,n,thresh", [(2, 200, 0.5), (1, 512, 0.7)])
def test_plain_equals_pallas_bitonic_interpret(bsz, n, thresh):
    boxes, scores, valid = _case(bsz * 1000 + n, bsz, n)
    want = np.asarray(nms_pallas_batched(
        jnp.asarray(boxes), jnp.asarray(scores), thresh, valid=jnp.asarray(valid),
        tile=128, order_mode="bitonic", interpret=True))
    got = _plain(boxes, scores, valid, thresh)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()  # suppression happened


@pytest.mark.parametrize("n,offset", [(97, 1.0), (256, 1.0), (333, 0.0)])
def test_plain_equals_fixpoint(n, offset):
    boxes, scores, valid = _case(n, 2, n, ties=4)
    got = _plain(boxes, scores, valid, 0.5, offset)
    for b in range(2):
        want = np.asarray(jnms.nms_mask(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), 0.5,
                                        valid=jnp.asarray(valid[b]), offset=offset,
                                        impl="fixpoint"))
        np.testing.assert_array_equal(got[b], want)


def test_plain_equals_fixpoint_above_8192():
    """N = 9000, above the kernel's shared-memory route: sparse boxes (a
    20000-pixel extent) keep the suppression chains short, so the fixpoint
    of both stays a few passes over the 9000 x 9000 matrix."""
    boxes, scores, valid = _case(9000, 1, 9000, ties=4, extent=20000.0)
    got = _plain(boxes, scores, valid, 0.5)
    want = np.asarray(jnms.nms_mask(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 0.5,
                                    valid=jnp.asarray(valid[0]), impl="fixpoint"))
    np.testing.assert_array_equal(got[0], want)
    assert 0 < got.sum() < valid.sum()


def test_plain_equals_host_greedy():
    """Host greedy on the valid rows; its float sort does not fold
    subnormals, so it gets the scores flushed to zero, which is what the
    folded key orders by."""
    boxes, scores, valid = _case(7, 2, 400)
    got = _plain(boxes, scores, valid, 0.7)
    for b in range(2):
        rows = np.flatnonzero(valid[b])
        s_ftz = np.where(np.abs(scores[b]) < np.finfo(np.float32).tiny, 0.0, scores[b])
        dets = np.concatenate([boxes[b], s_ftz[:, None]], axis=1)[rows].astype(np.float32)
        want = np.zeros(400, bool)
        want[rows[jnms.nms(dets, 0.7)]] = True
        np.testing.assert_array_equal(got[b], want)


def test_invalid_and_neg_inf_rows_never_kept():
    boxes, scores, valid = _case(11, 1, 64)
    scores[0, :5] = -np.inf
    valid[0, :5] = True  # the kernel's rule: a -inf score makes a row invalid
    keep = _plain(boxes, scores, valid, 0.5)
    assert not keep[0, :5].any() and not keep[0][~valid[0]].any()


@pytest.mark.parametrize("n,k", [(200, 30), (20, 50)])
def test_nms_topk_matches(n, k):
    rng = np.random.RandomState(n)
    boxes, scores, valid = _case(n + 1, 1, n)
    scores = np.where(np.abs(scores) < 1e-30, 0.0, scores).astype(np.float32)
    scores[0, rng.rand(n) < 0.1] = -0.0
    got = tnms.nms_topk(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]), 0.5, k,
                        valid=torch.from_numpy(valid[0]))
    want = jnms.nms_topk(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 0.5, k,
                         valid=jnp.asarray(valid[0]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_top_k_matches_lax_top_k():
    """Total float order (+0 above -0, subnormals apart), ties to the lower
    index, as jax.lax.top_k."""
    import jax

    rng = np.random.RandomState(9)
    x = (np.floor(rng.rand(3, 64) * 4) / 4).astype(np.float32)
    x[:, ::7] = -0.0
    x[0, 3:9] = [1e-40, -1e-40, 2e-40, 0.0, -0.0, -1e30]
    for k in (1, 10, 64):
        v_j, i_j = jax.lax.top_k(jnp.asarray(x), k)
        v_t, i_t = top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(v_t.numpy().view(np.int32), np.asarray(v_j).view(np.int32))


def test_cpu_dispatch_never_reaches_cuda_wrapper(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CUDA wrapper called for a CPU tensor")

    monkeypatch.setattr(nms_kernel, "nms_cuda_batched", boom)
    before = nms_kernel.LAUNCHES
    boxes, scores, valid = _case(3, 1, 50)
    keep = tnms.nms_mask(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]), 0.5,
                         torch.from_numpy(valid[0]))
    assert keep.dtype == torch.bool and keep.shape == (50,)
    assert nms_kernel.LAUNCHES == before


def test_cuda_wrapper_rejects_cpu_tensors():
    boxes, scores, valid = _case(4, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        nms_kernel.nms_cuda_batched(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
                                    torch.from_numpy(valid))


def _simulate_rank_sort(key, n_pad):
    """The sort pass of ``csrc/nms.cu`` in numpy: row i of the tile starting
    at i0 (64 rows) counts the rows before the tile with a key <= its own,
    the tile's rows with a smaller key or an equal key and a lower index,
    and the rows after the tile with a smaller key; the count is its
    position."""
    rank = np.zeros(n_pad, np.int64)
    for i0 in range(0, n_pad, 64):
        tile = np.arange(i0, i0 + 64)
        ki = key[tile][:, None]
        kj = key[None, i0:i0 + 64]
        earlier = tile[None, :] < tile[:, None]
        rank[tile] = ((key[None, :i0] <= ki).sum(1) + ((kj < ki) | ((kj == ki) & earlier)).sum(1)
                      + (key[None, i0 + 64:] < ki).sum(1))
    return rank


def _simulate_rank_sort_large(key, n_pad, chunk):
    """The large route's sort pass (``sort_kernel_large``) in numpy: the
    same counts, taken chunk by chunk of ``chunk`` keys with the kernel's
    bounds: in chunk ``c0`` the rows before ``min(i0, c0 + chunk)`` count
    with <=, the tile (when it lies in the chunk) by key and index, the
    rows from ``max(i0 + 64, c0)`` on with <."""
    rank = np.zeros(n_pad, np.int64)
    for c0 in range(0, n_pad, chunk):
        keys = key[c0:c0 + chunk]
        whole = np.sort(keys)
        for i0 in range(0, n_pad, 64):
            tile = np.arange(i0, i0 + 64)
            ki = key[tile]
            before = min(i0, c0 + chunk) - c0
            after = max(i0 + 64, c0) - c0
            if before > 0:
                part = whole if before == chunk else np.sort(keys[:before])
                rank[tile] += np.searchsorted(part, ki, side="right")
            if c0 <= i0 < c0 + chunk:
                kj = key[None, i0:i0 + 64]
                earlier = tile[None, :] < tile[:, None]
                rank[tile] += ((kj < ki[:, None]) | ((kj == ki[:, None]) & earlier)).sum(1)
            if after < chunk:
                part = whole if after == 0 else np.sort(keys[after:])
                rank[tile] += np.searchsorted(part, ki, side="left")
    return rank


@pytest.mark.parametrize("n,n_pad", [(2048, 2048), (3000, 4096), (5000, 8192), (100, 128),
                                     (40, 64), (8193, 16384), (20000, 32768),
                                     (40000, 65536), (65536, 65536)])
def test_rank_sort_is_a_stable_sort(n, n_pad):
    """The sort pass's counting, simulated, puts every row at its place in a
    stable sort of the folded keys: ties, +-0, subnormals (folded into one
    key), -inf and invalid rows (the last key), padding rows after them.
    Above 8192 rows, the large route's chunked counting."""
    assert nms_kernel.sort_width(n) == n_pad
    boxes, scores, valid = _case(n + 17, 1, n)
    scores[0, 5:9] = [np.float32(1e-42), -np.inf, np.float32(-1e-42), 0.0]
    s = np.where(valid[0], scores[0], -np.inf).astype(np.float32)
    key = np.full(n_pad, tnms.KEY_NEG_INF, np.int64)
    key[:n] = tnms.score_keys(torch.from_numpy(s)).numpy()
    if n_pad > nms_kernel.SMEM_MAX_N:
        rank = _simulate_rank_sort_large(key, n_pad, nms_kernel.SORT_CHUNK)
    else:
        rank = _simulate_rank_sort(key, n_pad)
    order = np.full(n_pad, -1)
    order[rank] = np.arange(n_pad)
    np.testing.assert_array_equal(order, np.argsort(key, kind="stable"))


@pytest.mark.parametrize("n_tiles", [1, 2, 32, 64, 128, 256, 512, 1024])
def test_mask_blocks_cover_the_upper_triangle_once(n_tiles):
    """The mask pass launches one block per tile at or right of the diagonal
    (n_tiles (n_tiles + 1) / 2 of them): block ``col (col + 1) / 2 + row``
    takes tile (row, col), as the kernel inverts the index, up to 1024
    tiles a side (N = 65536, the large route)."""
    blocks = n_tiles * (n_tiles + 1) // 2
    row, col = nms_kernel.triangle_tile(np.arange(blocks))
    want_col = np.repeat(np.arange(n_tiles), np.arange(1, n_tiles + 1))
    want_row = np.arange(blocks) - want_col * (want_col + 1) // 2
    np.testing.assert_array_equal(col, want_col)
    np.testing.assert_array_equal(row, want_row)
    assert (row <= col).all()
    if n_tiles <= 128:  # the scalar form, block by block
        tiles = [nms_kernel.triangle_tile(blk) for blk in range(blocks)]
        assert tiles == [(rt, ct) for ct in range(n_tiles) for rt in range(ct + 1)]


def test_scratch_is_one_buffer_of_the_three_pieces():
    for bsz, n_pad in [(1, 64), (16, 4096), (3, 8192), (1, 16384), (2, 32768), (1, 65536)]:
        words = n_pad // nms_kernel.TILE
        pieces = (bsz * n_pad * words * 8, bsz * n_pad * 16, bsz * n_pad * 4)
        assert nms_kernel.scratch_bytes(bsz, n_pad) == sum(pieces)
        assert all(p % 16 == 0 for p in pieces)  # each piece starts 16-byte aligned
