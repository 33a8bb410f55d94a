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


def _kernel_steps(a, b, off):
    """``csrc/iou.cu``'s float32 steps in its order, in NumPy."""
    f = np.float32
    off = f(off)
    r, c = a[:, None, :], b[None, :, :]
    iw = (np.minimum(r[..., 2], c[..., 2]) - np.maximum(r[..., 0], c[..., 0])) + off
    ih = (np.minimum(r[..., 3], c[..., 3]) - np.maximum(r[..., 1], c[..., 1])) + off
    inter = np.maximum(iw, f(0)) * np.maximum(ih, f(0))
    area_r = ((a[:, 2] - a[:, 0]) + off) * ((a[:, 3] - a[:, 1]) + off)
    area_c = ((b[:, 2] - b[:, 0]) + off) * ((b[:, 3] - b[:, 1]) + off)
    uni = (area_r[:, None] + area_c[None, :]) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(uni > 0, inter / uni, f(0)).astype(np.float32)


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


def test_bbox_overlaps_cuda_rejects_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only: nothing falls back."""
    a = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        iou_kernel.bbox_overlaps_cuda(a, a)
