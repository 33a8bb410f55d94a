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
