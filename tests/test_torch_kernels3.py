"""Port parity, the kernels of the detection slice on the CPU: the fused ROI
align (``'align_pallas'``), Caffe ROI max pooling (``'caffe_max'``) and the
fused conv1 block (``FUSE_CONV1``), each held against the JAX package on the
same NumPy inputs. The JAX Pallas kernels run in interpret mode.

Tolerances, with their reasons:

- fused ROI align: the port samples at ``lo + ((i + 0.5) / 2P) * size``
  with a true division, as the reference's code reads; XLA's compiled
  weights differ from that by up to ~1.5e-6 (measured), so bf16 outputs
  agree to one bf16 ulp of the output's magnitude (2**-7 relative; measured:
  0.3% of elements differ, by at most that) and f32 outputs to 1e-5 of the
  output's max |x|;
- ``roi_pool_caffe``: exactly (integer bins, max);
- ``fused_conv1_pool``: f32 to 1e-5 absolute (the reference test's bound);
  bf16 to one bf16 ulp (2**-7 relative) plus 1e-3 of the max: the f32 sums
  run in another order, and conv1_1's bf16 output rounds in two frameworks;
- the ``FUSE_CONV1`` trunk against the JAX trunk, which runs conv1 unfused
  on the CPU (its gate needs a TPU): 2e-2 of the output's max |x|, the bf16
  trunk bound of ``tests/test_torch_models.py`` (the fused block adds the
  conv1_1 bias after a bf16 rounding, the unfused one before).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aznet_tpu.models.vgg import VGG16Trunk as JVGG16Trunk
from aznet_tpu.ops.pallas import roi_kernel as jroi_kernel
from aznet_tpu.ops.pallas.conv1_kernel import fused_conv1_pool as jfused_conv1_pool
from aznet_tpu_torch.models.vgg import VGG16Trunk
from aznet_tpu_torch.ops import conv1_fused as tconv1
from aznet_tpu_torch.ops import roi_pool as troi
from aznet_tpu_torch.ops.cuda import roi_align_kernel
from aznet_tpu_torch.utils.convert import params_from_flax

jroi = importlib.import_module("aznet_tpu.ops.roi_pool")  # the package re-exports a function

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BF16_ULP = 2.0 ** -7


def _rois(rng, r, h, w, max_wh=400.0):
    x1 = rng.uniform(0, (w - 3) * 16, r)
    y1 = rng.uniform(0, (h - 3) * 16, r)
    return np.stack([x1, y1, x1 + rng.uniform(1, max_wh, r),
                     y1 + rng.uniform(1, max_wh, r)], 1).astype(np.float32)


def _assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got - want)
    assert (d <= BF16_ULP * np.abs(want) + 1e-6).all(), d.max()
    assert (d > 0).mean() < 0.02


@pytest.mark.parametrize("h,w,c,r", [(14, 18, 8, 40), (38, 50, 32, 20)])
def test_roi_align_fused_matches_pallas_h_first(h, w, c, r):
    rng = np.random.RandomState(h)
    feat = rng.randn(h, w, c).astype(np.float32)
    rois = _rois(rng, r, h, w)
    want = jroi_kernel.roi_align_pallas(jnp.asarray(feat, jnp.bfloat16), jnp.asarray(rois),
                                        1 / 16.0, 7, interpret=True)
    tf = torch.from_numpy(feat).to(torch.bfloat16)
    assert not troi.fused_w_first(h, w, c, 2)
    got = troi.roi_pool(tf, torch.from_numpy(rois), 1 / 16.0, 7, mode="align_pallas")
    assert got.dtype == torch.bfloat16 and got.shape == (r, 7, 7, c)
    _assert_bf16_close(got.float(), want)


def test_roi_align_fused_matches_pallas_big_w_first():
    """The f32 map over the footprint rule: ``roi_align_pallas`` dispatches to
    the W-first tiled kernel, and so does the port."""
    rng = np.random.RandomState(3)
    h, w, c = 34, 60, 512
    feat = rng.randn(h, w, c).astype(np.float32)
    rois = np.concatenate([np.array([[0, 0, 900, 500], [64, 32, 400, 300]], np.float32),
                           _rois(rng, 6, h, w)])
    assert troi.fused_w_first(h, w, c, 4)
    want = np.asarray(jroi_kernel.roi_align_pallas(jnp.asarray(feat), jnp.asarray(rois),
                                                   1 / 16.0, 7, interpret=True))
    got = troi.roi_align_fused(torch.from_numpy(feat), torch.from_numpy(rois), 1 / 16.0, 7)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_fused_reference_w_first_matches_big(dtype):
    """The W-first order alone, on a small map, against the tiled kernel
    (several h and c tiles)."""
    rng = np.random.RandomState(9)
    h, w, c = 21, 26, 24
    feat = rng.randn(h, w, c).astype(np.float32)
    rois = _rois(rng, 21, h, w, 250.0)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jroi_kernel.roi_align_pallas_big(
        jnp.asarray(feat, jd), jnp.asarray(rois), 1 / 16.0, 7, tile_r=16, tile_h=8, tile_c=8,
        interpret=True), np.float32)
    got = troi.roi_align_fused_reference(torch.from_numpy(feat).to(td), torch.from_numpy(rois),
                                         1 / 16.0, 7, w_first=True).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    else:
        _assert_bf16_close(got, want)


def test_fused_taps_are_the_dense_weights():
    """The four tap slots per bin hold exactly the reference's dense
    bilinear-average weights (``_bilinear_pool_weights``, computed op by
    op), with no cell counted twice."""
    rng = np.random.RandomState(2)
    extent = 19
    lo = np.concatenate([rng.uniform(-3, extent, 60), [0.0, extent - 1.0, 5.0]]).astype(np.float32)
    size = np.concatenate([rng.uniform(0.5, 40, 60), [1.0, 3.0, 13.999]]).astype(np.float32)
    size = np.maximum(size, 1.0)
    want = np.asarray(jroi._bilinear_pool_weights(jnp.asarray(lo), jnp.asarray(size), extent, 7, 2))
    cells, wts = troi.fused_taps(torch.from_numpy(lo), torch.from_numpy(size), extent, 7)
    dense = np.zeros_like(want)
    np.add.at(dense, (np.arange(len(lo))[:, None, None], np.arange(7)[None, :, None],
                      cells.numpy()), wts.numpy())
    np.testing.assert_array_equal(dense, want)
    assert (cells.numpy() >= 0).all() and (cells.numpy() < extent).all()


@pytest.mark.parametrize("n", [12, 14, 3, 61])
def test_sample_grid_is_a_true_division(n):
    """The sample grid of both ROI aligns is ``(i + 0.5) / n`` in float32,
    as NumPy's true division computes it (P = 6 and 7 with two samples give
    n = 12 and 14, where ``x * (1 / n)`` differs in 4 and 8 places)."""
    i = np.arange(n, dtype=np.float32) + np.float32(0.5)
    want = i / np.float32(n)
    assert (want != i * (np.float32(1) / np.float32(n))).any()  # the case matters
    np.testing.assert_array_equal(troi.sample_grid(n, "cpu").numpy(), want)


@pytest.mark.parametrize("r,c,pool", [(300, 512, 7), (8, 512, 7), (32, 512, 7), (64, 512, 7),
                                      (128, 1024, 7), (8, 1024, 7), (33, 40, 7), (1, 200, 7),
                                      (64, 512, 6), (5, 36, 16), (2, 3, 1)])
def test_roi_align_plan_covers_every_output_once(r, c, pool):
    """The CUDA kernel's launch plan and index arithmetic (mirrored by
    ``block_work``): over the grid's second axis and a block's threads,
    every (first-axis bin, second-axis bin, channel) of a roi is computed
    exactly once (every roi is one column of blocks); blocks stay within
    512 threads; the second axis is split only at small R."""
    s, per = roi_align_kernel.launch_plan(r, c, pool, sms=132)
    assert 1 <= s <= roi_align_kernel.MAX_SLAB_THREADS and 1 <= per <= pool
    assert pool * s <= 512
    count = np.zeros((pool, pool, c), np.int32)
    grid_y = -(-c // (8 * s)) * -(-pool // per)  # slabs x second-axis groups
    for by in range(grid_y):
        for t in range(pool * s):
            work = roi_align_kernel.block_work(c, pool, s, per, by, t)
            if work is not None:
                i, js, chs = work
                for j in js:
                    count[i, j, chs.start:chs.stop] += 1
    np.testing.assert_array_equal(count, 1)
    # Enough blocks: all second-axis bins share one block's cells; else split.
    assert (per == pool) == (r * -(-c // (8 * s)) >= 2 * 132 or pool == 1)


def test_roi_pool_modes_dispatch_and_reject():
    feat = torch.zeros((4, 5, 8))
    rois = torch.tensor([[0.0, 0.0, 30.0, 30.0]])
    assert troi.roi_pool(feat, rois, 1 / 16.0, 7, mode="caffe_max").shape == (1, 7, 7, 8)
    with pytest.raises(ValueError, match="POOLING_MODE"):
        troi.roi_pool(feat, rois, 1 / 16.0, 7, mode="bilinear")
    with pytest.raises(ValueError, match="int8 features"):
        troi.roi_pool(feat.to(torch.int8), rois, 1 / 16.0, 7, mode="align_pallas")
    with pytest.raises(TypeError, match="bf16 or f32"):
        troi.roi_align_fused(feat.double(), rois, 1 / 16.0, 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_pool_caffe_matches_reference_np(dtype):
    rng = np.random.RandomState(5)
    h, w, c = 13, 17, 6
    feat = rng.randn(h, w, c).astype(np.float32)
    if dtype == "bfloat16":
        feat = np.asarray(torch.from_numpy(feat).to(torch.bfloat16).float())
    rois = np.concatenate([_rois(rng, 45, h, w, 300.0),
                           np.array([[0, 0, 0, 0], [100, 50, 90, 40], [0, 0, 300, 250],
                                     [8.0, 8.0, 8.49, 39.51]], np.float32)])
    want = jroi.roi_pool_caffe_reference_np(feat, rois, 1 / 16.0, 7)
    tf = torch.from_numpy(feat).to(getattr(torch, dtype))
    got = troi.roi_pool(tf, torch.from_numpy(rois), 1 / 16.0, 7, mode="caffe_max")
    assert got.dtype == tf.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    jgot = np.asarray(jroi.roi_pool_caffe(jnp.asarray(feat), jnp.asarray(rois), 1 / 16.0, 7))
    np.testing.assert_array_equal(jgot, want)


def _conv1_params(rng, c):
    return (rng.rand(3, 3, 3, c).astype(np.float32) - 0.5,
            rng.rand(c).astype(np.float32) * 0.1,
            (rng.rand(3, 3, c, c).astype(np.float32) - 0.5) * 0.2,
            rng.rand(c).astype(np.float32) * 0.1)


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_conv1_pool_matches_pallas(dtype):
    rng = np.random.RandomState(7)
    b, h, w, c = 2, 64, 48, 16
    x = rng.rand(b, h, w, 3).astype(np.float32) * (255.0 if dtype == "bfloat16" else 1.0)
    w11, b11, w12, b12 = _conv1_params(rng, c)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    cast = lambda a: jnp.asarray(a, jd)
    want = np.asarray(jfused_conv1_pool(cast(x), cast(w11), cast(b11), cast(w12), cast(b12),
                                        interpret=True), np.float32)
    tcast = lambda t: t.to(td)
    got = tconv1.fused_conv1_pool(tcast(torch.from_numpy(x)), tcast(_oihw(w11)),
                                  tcast(torch.from_numpy(b11)), tcast(_oihw(w12)),
                                  tcast(torch.from_numpy(b12)))
    assert got.dtype == td and got.shape == (b, h // 2, w // 2, c)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        d = np.abs(got - want)
        assert (d <= BF16_ULP * np.abs(want) + 1e-3 * np.abs(want).max()).all(), d.max()


def test_fused_conv1_reference_is_the_plain_block():
    """The plain conv1_2 step equals conv2d + bias + ReLU + max-pool in f32."""
    rng = np.random.RandomState(8)
    y = torch.from_numpy(rng.rand(2, 8, 10, 16).astype(np.float32))
    _, _, w12, b12 = _conv1_params(rng, 16)
    got = tconv1.conv1_2_pool_reference(y, _oihw(w12), torch.from_numpy(b12))
    ref = torch.nn.functional.conv2d(y.permute(0, 3, 1, 2), _oihw(w12), torch.from_numpy(b12),
                                     padding=1)
    ref = torch.nn.functional.max_pool2d(torch.relu(ref), 2).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw,fused", [((64, 80), True), ((48, 80), False)])
def test_fuse_conv1_trunk_matches_jax(hw, fused):
    """``FUSE_CONV1`` VGG-16 trunk (bf16, WIDTH 0.25: C=16) against the JAX
    trunk. 64 rows pass the H % 32 gate and take the fused block; 48 rows
    take the plain layers and equal the unfused port trunk exactly."""
    x = np.random.RandomState(4).uniform(-120, 120, (2,) + hw + (3,)).astype(np.float32)
    jm = JVGG16Trunk(dtype=jnp.bfloat16, width=0.25, fuse_conv1=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)), np.float32)
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    trunks = []
    for fuse in (True, False):
        t = VGG16Trunk(width=0.25, fuse_conv1=fuse)
        t.load_state_dict(sd)
        trunks.append(t.eval().to(torch.bfloat16))
    calls = []
    orig = tconv1.conv1_2_pool_reference
    spy = lambda *a: calls.append(1) or orig(*a)
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconv1, "conv1_2_pool_reference", spy)
        got = trunks[0](torch.from_numpy(x))
        plain = trunks[1](torch.from_numpy(x))
    assert len(calls) == int(fused)
    assert got.dtype == torch.bfloat16 and got.shape == (2, hw[0] // 16, hw[1] // 16, 128)
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    if not fused:
        np.testing.assert_array_equal(got, plain.float().numpy())
