"""Port parity, int8: quantization, the int8 conv's plain version, the int8
trunk walk, calibration, int8 ROI align, the int8 head and the int8 propose
path, each against the JAX package on the same NumPy inputs (weights through
``params_from_flax``). The JAX side runs its Pallas int8 kernels in interpret
mode (``interpret=True``, or ``AZNET_INT8_INTERPRET=1`` for the trunk).

Tolerances:
- bit-exact: ``pack_weights_9``, ``quantize_acts``, the per-column head
  quantization, ``division_tree_regions``; the plain conv against the Pallas
  chain and strip kernels on integer grids at power-of-two scales (int32
  sums, reciprocal requantization exact), int8, bf16 and f32 outputs.
- The plain conv at calibrated (non power-of-two) scales: JAX's interpret
  epilogue on the CPU may contract ``acc * s + b`` into an FMA, so codes may
  differ by 1 on at most 0.1% of the elements.
- The trunk walk: the bf16 prefix convs sum in another order than XLA's, so
  the codes quantized from them, and the codes downstream, may differ by one
  step at a few elements; the bf16 output differs by at most 2% of its
  maximum, on at most 1% of the elements by more than one bf16 step.
- The dx-packed conv (``INT8_BACKEND='xla'``) against
  ``aznet_tpu.ops.conv_int8.conv3x3_int8`` run eagerly: bit-exact on
  integer grids at power-of-two scales (int8, bf16 and f32 exits); at
  calibrated scales codes within 1 on at most 0.1% of the elements (an
  FMA contraction of the epilogue, were JAX to make one, moves a code).
  ``quantize_weights`` and ``dx_pack`` bit-exact.
- The ``'xla'`` walk and the chain walk from conv1_2: the trunk walk's
  bounds below. The rule that selects the trunk from conv1_2: where the
  reference keeps the default prefix, each package's result equals its own
  ``'conv2_2'`` result exactly.
- Calibration: relative error 1e-5 (float32 convs sum in another order).
- ``roi_align_int8``: the second contraction sums in float32 in another
  order before ``round``, so a code may differ by 1 on at most 0.1% of the
  elements.
- The int8 head's logits on the same int8 features: 1e-6 (measured:
  bit-exact).
- Int8 ``im_propose`` / ``make_propose_batch`` (``'pallas_strip'`` and
  ``'xla'``): the features and the first
  level's head outputs are bit-exact here, but the search runs ROI align at
  every level, where a code may flip (above), and the random-init head puts
  the top scores within ~3e-5 of each other, so near-ties may swap. Held:
  the same number of proposals; the sorted scores to 1e-4; and at least 80%
  of the port's boxes within 0.5 px of a JAX box of the same image.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aznet_tpu import api as japi
from aznet_tpu.config import Config, ModelConfig, cfg_from_dict
from aznet_tpu.models import vgg as jvgg
from aznet_tpu.ops import conv_int8 as jconv
from aznet_tpu.ops import quant as jquant
from aznet_tpu.ops.pallas import conv_int8_chain as jchain
from aznet_tpu.ops.pallas.conv_int8_kernel import conv3x3_int8_pallas
from aznet_tpu.ops.pallas.conv_int8_kernel import pack_weights_9 as jpack
from aznet_tpu.ops.roi_pool import roi_align_int8 as jroi_align_int8
from aznet_tpu.train.labels import division_tree_regions as jdivision_tree_regions
from aznet_tpu_torch import api as tapi
from aznet_tpu_torch.models import aznet as taznet
from aznet_tpu_torch.models import vgg as tvgg
from aznet_tpu_torch.ops import conv_int8 as tconv
from aznet_tpu_torch.ops import quant as tquant
from aznet_tpu_torch.ops.cuda import conv_int8_kernel as ck
from aznet_tpu_torch.ops.roi_pool import roi_align_int8
from aznet_tpu_torch.search.templates import division_tree_regions
from aznet_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SMALL = {
    "MODEL": {"BACKBONE": "vgg16", "WIDTH": 0.125, "FC_DIM": 32, "NUM_TEMPLATES": 5,
              "COMPUTE_DTYPE": "float32"},
    "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 2, "NUM_PROPOSALS": 10},
    "TEST": {"SCALES": [64], "MAX_SIZE": 128},
}


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _layer(w_q9: np.ndarray, s_w: np.ndarray, bias: np.ndarray) -> tconv.Int8Conv:
    return tconv.Int8Conv(tconv.kernel_layout(torch.tensor(w_q9)), torch.tensor(s_w),
                          torch.tensor(bias))


# -- quantization ------------------------------------------------------------


def test_pack_and_quantize_bit_exact():
    rng = np.random.RandomState(0)
    w = (rng.randn(3, 3, 24, 40) * 0.07).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero channel takes the 1e-12 floor
    jq, js = jpack(jnp.asarray(w))
    tq, ts = tconv.pack_weights_9(torch.from_numpy(w).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    x = (rng.randn(4, 7, 9, 16) * 3).astype(np.float32)
    x[0, 0, 0, :4] = [0.5, 1.5, -2.5, 400.0]  # ties to even, clip
    for scale in (0.0419, 0.5, 1.0 / 3.0):
        np.testing.assert_array_equal(
            tconv.quantize_acts(torch.from_numpy(x), scale).numpy(),
            np.asarray(jconv.quantize_acts(jnp.asarray(x), scale)))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        tconv.quantize_acts(xb, 0.0419).numpy(),
        np.asarray(jconv.quantize_acts(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                                       0.0419)))

    # per-column head quantization (models/heads.py:67-70 of the reference)
    k = (rng.randn(200, 48) * 0.02).astype(np.float32)  # Dense kernel [in, out]
    jk = jnp.asarray(k)
    jsw = jnp.maximum(jnp.max(jnp.abs(jk), axis=0) / jconv.INT8_MAX, 1e-12)
    jwq = jnp.clip(jnp.round(jk / jsw), -jconv.INT8_MAX, jconv.INT8_MAX).astype(jnp.int8)
    twq, tsw = tconv.quantize_columns(torch.from_numpy(k.T.copy()))
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq).T)
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))


# -- the CUDA kernel's host side: weight layout and tiles --------------------


@pytest.mark.parametrize("c,co", [(8, 8), (24, 40), (64, 128), (128, 192), (256, 640)])
def test_kernel_layout_unpacks_to_pack_weights_9(c, co):
    """The tiled layout holds ``pack_weights_9``'s integers, zeros in the
    padding, and one contiguous ``[half, tap, n, 16]`` piece per block of 128
    output channels and chunk of 32 input channels, where the kernel's bulk
    copy reads it."""
    rng = np.random.RandomState(c + co)
    w = torch.from_numpy((rng.randn(co, c, 3, 3) * 0.05).astype(np.float32))
    q9, _ = tconv.pack_weights_9(w)
    w_k = tconv.kernel_layout(q9)
    tiles, chunks = -(-co // 128), -(-c // 32)
    assert w_k.shape == (tiles, chunks, 2, 9, 128, 16) and w_k.is_contiguous()
    assert torch.equal(tconv.unpack_kernel_layout(w_k, c, co), q9)
    full = tconv.unpack_kernel_layout(w_k, chunks * 32, tiles * 128)
    assert not full[:, c:].any() and not full[:, :, co:].any()
    flat = w_k.reshape(-1)
    for tile in range(tiles):
        for chunk in range(chunks):
            piece = flat[(tile * chunks + chunk) * 36864:][:36864].reshape(2, 9, 128, 16)
            want = full[:, chunk * 32:chunk * 32 + 32, tile * 128:tile * 128 + 128]
            assert torch.equal(piece, want.reshape(9, 2, 16, 128).permute(1, 0, 3, 2))


def _cover(n, step, count):
    """How many of ``count`` spans of ``step`` from 0 hold each of n indices."""
    hits = np.zeros(n, int)
    for k in range(count):
        hits[k * step:k * step + step] += 1
    return hits


# (B, H, W, Co): the 10 main-path layers' maps (b=2 and b=1, 608x800 canvas)
# and the card tests' ragged cases.
TILE_SHAPES = [(2, 304, 400, 128), (2, 152, 200, 256), (2, 76, 100, 512), (2, 38, 50, 512),
               (1, 304, 400, 128), (1, 152, 200, 256), (1, 76, 100, 512), (1, 38, 50, 512),
               (3, 14, 50, 512), (1, 11, 70, 128), (1, 10, 66, 192), (1, 7, 33, 640),
               (2, 6, 66, 40), (1, 5, 33, 8), (2, 12, 130, 64)]


@pytest.mark.parametrize("b,h,w,co", TILE_SHAPES)
def test_conv_int8_tiles_cover_once(b, h, w, co):
    """The grid's blocks cover every output pixel and channel exactly once,
    with no empty block, and every 2x2 pool window lies inside one block."""
    for n_sms in (132, 114, 8):
        rows = ck.tile_rows(b, h, w, co, n_sms)
        assert rows in (2, 4)  # even: a pool window's two rows share a block
        gx, gy, gz = ck.grid(b, h, w, co, rows)
        tiles = -(-co // ck.CO_TILE)
        assert gz == b * tiles
        assert (_cover(h, rows, gy) == 1).all() and (gy - 1) * rows < h
        assert (_cover(w, ck.TILE_COLS, gx) == 1).all() and (gx - 1) * ck.TILE_COLS < w
        assert (_cover(co, ck.CO_TILE, tiles) == 1).all()
        pool_rows = np.arange(h // 2 * 2).reshape(-1, 2) // rows
        pool_cols = np.arange(w // 2 * 2).reshape(-1, 2) // ck.TILE_COLS
        assert (pool_rows[:, 0] == pool_rows[:, 1]).all()
        assert (pool_cols[:, 0] == pool_cols[:, 1]).all()


def test_conv_int8_tile_choice():
    """4 rows a block on the main path at b=2; 2 on conv5 at b=1 (40 blocks
    of 4 rows would leave 92 of 132 SMs idle)."""
    for b, h, w, co in TILE_SHAPES[:4]:
        assert ck.tile_rows(b, h, w, co, 132) == 4
    assert ck.tile_rows(1, 38, 50, 512, 132) == 2
    assert ck.chunk_cycles(4) == 9 * 64 * 4  # the tensor cores bound the 4-row tile
    assert ck.chunk_cycles(2) > 9 * 64 * 2  # the chunk's bytes bound the 2-row tile


# -- the conv's plain version against the Pallas kernels ---------------------


def _grid_case(rng, bsz, h, w, c, co):
    x = rng.randint(-5, 6, (bsz, h, w, c)).astype(np.int8)
    wts = rng.randint(-3, 4, (9, c, co)).astype(np.int8)
    bias = rng.randint(-2, 3, (co,)).astype(np.float32)
    return x, wts, np.ones((co,), np.float32), bias


@pytest.mark.parametrize("h,w,pool,t", [(20, 24, True, 8), (13, 10, False, 8),
                                        (8, 10, True, 8), (18, 18, True, 16)])
def test_plain_conv_equals_chain_kernel_on_grids(h, w, pool, t):
    """int8 out at s_out = 64 (pool and no pool), and the exit in bf16 and f32."""
    rng = np.random.RandomState(7 + h)
    x, wts, sw, bias = _grid_case(rng, 2, h, w, 128, 128)
    layer = _layer(wts, sw, bias)
    args = (jchain.halo_layout(jnp.asarray(x)), 1.0, jnp.asarray(wts), jnp.asarray(sw),
            jnp.asarray(bias), h, w)
    want = jchain.conv3x3_int8_chain(*args, s_out=64.0, pool=pool, t_rows=t, interpret=True)
    ho, wo = (h // 2, w // 2) if pool else (h, w)
    got = tconv.conv3x3_int8_reference(torch.from_numpy(x), 1.0, layer, 64.0, pool=pool)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want[:, :ho, 1:1 + wo]))
    assert int(got.abs().max()) > 1
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        want = jchain.conv3x3_int8_chain(*args, s_out=None, out_dtype=jdt, t_rows=t,
                                         interpret=True)[:, :h]
        got = tconv.conv3x3_int8_reference(torch.from_numpy(x), 1.0, layer, None,
                                           out_dtype=tdt)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def _calibrated_case(seed, bsz, h, w, c, co):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 90, (bsz, h, w, c)).astype(np.int8)
    wq, sw = jpack(jnp.asarray((rng.randn(3, 3, c, co) * 0.05).astype(np.float32)))
    bias = rng.uniform(-0.5, 0.5, co).astype(np.float32)
    return x, np.asarray(wq), np.asarray(sw), bias


def _assert_codes_close(got, want, frac=1e-3):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


def test_plain_conv_calibrated_scales_chain():
    x, wq, sw, bias = _calibrated_case(3, 2, 12, 16, 128, 128)
    s_x, s_out = 0.0419, 0.3717
    want = jchain.conv3x3_int8_chain(
        jchain.halo_layout(jnp.asarray(x)), s_x, jnp.asarray(wq), jnp.asarray(sw),
        jnp.asarray(bias), 12, 16, s_out=s_out, pool=True, t_rows=8, interpret=True)
    got = tconv.conv3x3_int8_reference(torch.from_numpy(x), s_x, _layer(wq, sw, bias),
                                       s_out, pool=True)
    assert int(got.abs().max()) > 20
    _assert_codes_close(got.numpy(), np.asarray(want[:, :6, 1:9]))


@pytest.mark.parametrize("c", [64, 128])
def test_plain_conv_equals_strip_kernel(c):
    """The strip entry (no pool) against conv3x3_int8_pallas, including a
    C=64 input (the Pallas kernel pads it to 128 lanes): integer grids at
    s_out = 32 exactly, calibrated scales within the stated bound."""
    rng = np.random.RandomState(c)
    x, wts, sw, bias = _grid_case(rng, 2, 13, 17, c, 128)
    want = conv3x3_int8_pallas(jnp.asarray(x), 1.0, jnp.asarray(wts), jnp.asarray(sw),
                               jnp.asarray(bias), s_out=32.0, interpret=True)
    got = tconv.conv3x3_int8_reference(torch.from_numpy(x), 1.0, _layer(wts, sw, bias), 32.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    x, wq, sw, bias = _calibrated_case(c + 1, 1, 9, 11, c, 128)
    want = conv3x3_int8_pallas(jnp.asarray(x), 0.0419, jnp.asarray(wq), jnp.asarray(sw),
                               jnp.asarray(bias), s_out=0.4441, interpret=True)
    got = tconv.conv3x3_int8_reference(torch.from_numpy(x), 0.0419, _layer(wq, sw, bias),
                                       0.4441)
    _assert_codes_close(got.numpy(), np.asarray(want))


# -- the dx-packed conv (INT8_BACKEND='xla') ---------------------------------


def test_quantize_weights_and_dx_pack_bit_exact():
    rng = np.random.RandomState(1)
    w = (rng.randn(3, 3, 24, 40) * 0.07).astype(np.float32)
    w[..., 5] = 0.0  # an all-zero channel takes the 1e-12 floor
    jq, js = jconv.quantize_weights(jnp.asarray(w))
    tq, ts = tconv.quantize_weights(torch.from_numpy(w).permute(3, 2, 0, 1))
    assert tq.dtype == torch.int8 and tq.shape == (3, 72, 40)
    assert all(tq[dy].t().is_contiguous() for dy in range(3))  # the card GEMM's operand layout
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    xp = rng.randint(-127, 128, (2, 9, 12, 16)).astype(np.int8)
    np.testing.assert_array_equal(tconv.dx_pack(torch.from_numpy(xp)).numpy(),
                                  np.asarray(jconv.dx_pack(jnp.asarray(xp))))


def _dx_pair(x, s_x, w, bias, s_out, jdt=jnp.bfloat16, tdt=torch.bfloat16):
    """The reference's dx conv (eager) and the port's on the same HWIO ``w``."""
    jq, js = jconv.quantize_weights(jnp.asarray(w))
    want = jconv.conv3x3_int8(jnp.asarray(x), s_x, jq, js, jnp.asarray(bias), s_out=s_out,
                              out_dtype=jdt)
    tq, ts = tconv.quantize_weights(torch.from_numpy(w).permute(3, 2, 0, 1))
    got = tconv.conv3x3_int8_dx(torch.from_numpy(x), s_x, tq, ts, torch.from_numpy(bias),
                                s_out, out_dtype=tdt)
    return got, np.asarray(want)


@pytest.mark.parametrize("bsz,h,w,c,co", [(2, 13, 17, 64, 128), (1, 8, 10, 16, 32),
                                          (2, 5, 7, 24, 40), (1, 4, 4, 128, 64)])
def test_dx_conv_matches(bsz, h, w, c, co):
    """Integer grids (weights with a 127 in every column, so s_w = 1) at
    s_x = 1: int8 codes at s_out = 32 and the bf16 and f32 exits bit for bit;
    then calibrated scales within the stated bound."""
    rng = np.random.RandomState(c + co)
    x = rng.randint(-5, 6, (bsz, h, w, c)).astype(np.int8)
    wts = rng.randint(-3, 4, (3, 3, c, co)).astype(np.float32)
    wts[1, 1, 0, :] = 127.0
    bias = rng.randint(-2, 3, (co,)).astype(np.float32)
    got, want = _dx_pair(x, 1.0, wts, bias, 32.0)
    assert got.dtype == torch.int8 and got.shape == (bsz, h, w, co)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.abs().max()) > 1
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        got, want = _dx_pair(x, 1.0, wts, bias, None, jdt, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))

    x = rng.randint(0, 90, (bsz, h, w, c)).astype(np.int8)
    wts = (rng.randn(3, 3, c, co) * 0.05).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, co).astype(np.float32)
    got, want = _dx_pair(x, 0.0419, wts, bias, 0.3717)
    assert int(got.abs().max()) > 5
    _assert_codes_close(got.numpy(), want)


# -- the trunk walk ----------------------------------------------------------


def _trunk_pair(x, jtrunk, ttrunk, seed):
    params = jtrunk.init(jax.random.PRNGKey(seed), jnp.asarray(x[:1]))
    ttrunk.load_state_dict(params_from_flax(_np_tree(params)))
    ttrunk.prepare_int8()
    want = np.asarray(jtrunk.apply(params, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = ttrunk(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    return got.float().numpy(), want


def _assert_trunk_close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0
    d = np.abs(got - want)
    assert d.max() <= 2e-2 * scale, (d.max(), scale)
    ulp = np.maximum(np.abs(want), 1e-3) * 2.0 ** -7  # one bf16 step
    assert (d > ulp).mean() <= 1e-2, (d > ulp).mean()


def _spy(monkeypatch, module, name, record):
    real = getattr(module, name)

    def spy(*a, **k):
        record(a, k)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)


def test_int8_trunk_chain_walk_matches(monkeypatch):
    """The 128-channel mini layout of tests/test_int8.py in both packages:
    22x20 fuses the pool into conv2_2; 21x18 takes the odd-size fallback."""
    mini = (("conv1_1", 128), ("conv2_1", 128), ("conv2_2", 128),
            ("pool2", None), ("conv3_1", 128), ("conv3_2", 128))
    for mod in (jvgg, tvgg):
        monkeypatch.setattr(mod, "VGG16_LAYOUT", mini)
        monkeypatch.setattr(mod.VGG16Trunk, "_INT8_BF16_PREFIX", ("conv1_1",))
    monkeypatch.setenv("AZNET_INT8_INTERPRET", "1")
    jcalls, fused = [], []
    _spy(monkeypatch, jchain, "conv3x3_int8_chain", lambda a, k: jcalls.append(1))
    _spy(monkeypatch, tvgg, "conv3x3_int8", lambda a, k: fused.append(k.get("pool", False)))
    scales = (0.5, 0.125, 0.125, 0.125)  # powers of two
    rng = np.random.RandomState(5)
    for hw, out_hw, n_fused in (((22, 20), (11, 10), 1), ((21, 18), (10, 9), 0)):
        x = rng.uniform(-1, 1, (2,) + hw + (3,)).astype(np.float32)
        jt = jvgg.VGG16Trunk(dtype=jnp.bfloat16, int8_mode=True, int8_scales=scales)
        tt = tvgg.VGG16Trunk(int8_mode=True, int8_scales=scales)
        fused.clear()
        got, want = _trunk_pair(x, jt, tt, 0)
        assert want.shape == (2,) + out_hw + (128,)
        assert sum(fused) == n_fused and len(fused) == 4
        _assert_trunk_close(got, want)
    assert len(jcalls) == 8  # the reference took its chain path: 4 layers x 2 sizes


def test_int8_trunk_strip_walk_matches(monkeypatch):
    """VGG-16 at WIDTH 0.125 on 64x64: the chain check fails (16 channels),
    so both packages take the strip path with separate pools."""
    monkeypatch.setenv("AZNET_INT8_INTERPRET", "1")
    jcalls = []
    _spy(monkeypatch, jchain, "conv3x3_int8_chain", lambda a, k: jcalls.append(1))
    x = np.random.RandomState(2).uniform(-120, 120, (2, 64, 64, 3)).astype(np.float32)
    scales = tuple(2.0 ** -k for k in (2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6))
    jt = jvgg.VGG16Trunk(dtype=jnp.bfloat16, width=0.125, int8_mode=True, int8_scales=scales)
    tt = tvgg.VGG16Trunk(width=0.125, int8_mode=True, int8_scales=scales)
    got, want = _trunk_pair(x, jt, tt, 1)
    assert got.shape == (2, 4, 4, 64)
    assert not jcalls
    _assert_trunk_close(got, want)


def test_int8_trunk_xla_walk_matches(monkeypatch):
    """``INT8_BACKEND='xla'``, VGG-16 at WIDTH 0.125 on 64x64 in both
    packages (the reference's portable walk needs no interpret mode): the
    bf16 prefix, every later conv as dx-packed GEMMs, separate int8 pools."""
    calls = []
    _spy(monkeypatch, tvgg, "conv3x3_int8_dx", lambda a, k: calls.append("dx"))
    _spy(monkeypatch, tvgg, "conv3x3_int8", lambda a, k: calls.append("kernel"))
    x = np.random.RandomState(3).uniform(-120, 120, (2, 64, 64, 3)).astype(np.float32)
    scales = tuple(2.0 ** -k for k in (2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6))
    jt = jvgg.VGG16Trunk(dtype=jnp.bfloat16, width=0.125, int8_mode=True, int8_scales=scales,
                         int8_backend="xla")
    tt = tvgg.VGG16Trunk(width=0.125, int8_mode=True, int8_scales=scales, int8_backend="xla")
    got, want = _trunk_pair(x, jt, tt, 3)
    assert got.shape == (2, 4, 4, 64)
    assert calls == ["dx"] * 10
    _assert_trunk_close(got, want)


# 64-wide conv1_1 and conv1_2, pool1, then 128-wide layers: the reference's
# extended chain pads conv1_2's and conv2_1's 64 channels to 128 lanes.
CONV1_2_MINI = (("conv1_1", 64), ("conv1_2", 64), ("pool1", None), ("conv2_1", 128),
                ("conv2_2", 128), ("pool2", None), ("conv3_1", 128))


@pytest.mark.parametrize("hw,out_hw,fused", [((20, 24), (5, 6), [True, False, True, False]),
                                             ((21, 18), (5, 4), [False, False, False, False])])
def test_int8_trunk_chain_from_conv1_2_matches(monkeypatch, hw, out_hw, fused):
    """``INT8_CHAIN_FROM='conv1_2'`` on the mini layout: only conv1_1 stays
    bf16 in both packages. The reference takes its extended chain (4 chain
    kernel calls, conv1_2's input padded to 128 lanes); the port launches
    conv1_2 at C=64 with pool1 fused at the even size, and runs the pools
    apart at the odd size (the reference's fallback)."""
    for mod in (jvgg, tvgg):
        monkeypatch.setattr(mod, "VGG16_LAYOUT", CONV1_2_MINI)
    monkeypatch.setenv("AZNET_INT8_INTERPRET", "1")
    jcalls, tcalls = [], []
    _spy(monkeypatch, jchain, "conv3x3_int8_chain", lambda a, k: jcalls.append(a[0].shape[-1]))
    _spy(monkeypatch, tvgg, "conv3x3_int8",
         lambda a, k: tcalls.append((a[0].shape[-1], k.get("pool", False))))
    scales = (0.5, 0.125, 0.125, 0.125)
    x = np.random.RandomState(6).uniform(-1, 1, (2,) + hw + (3,)).astype(np.float32)
    jt = jvgg.VGG16Trunk(dtype=jnp.bfloat16, int8_mode=True, int8_scales=scales,
                         int8_chain_from="conv1_2")
    tt = tvgg.VGG16Trunk(int8_mode=True, int8_scales=scales, int8_chain_from="conv1_2")
    assert tt.int8_bf16_prefix == ("conv1_1",)
    got, want = _trunk_pair(x, jt, tt, 7)
    assert want.shape == (2,) + out_hw + (128,)
    assert jcalls == [128] * 4
    assert tcalls == [(64, fused[0]), (64, False), (128, fused[2]), (128, False)]
    _assert_trunk_close(got, want)


@pytest.mark.parametrize("case", ["pallas_strip", "narrow_conv1"])
def test_int8_chain_from_conv1_2_selection_rule(monkeypatch, case):
    """Where the reference keeps its default prefix under
    ``INT8_CHAIN_FROM='conv1_2'`` (the ``'pallas_strip'`` backend; a conv1
    narrower than 64, here a layout at WIDTH 0.5 whose later widths stay
    multiples of 128), each package's trunk equals its own ``'conv2_2'``
    trunk, and the port warns once."""
    monkeypatch.setenv("AZNET_INT8_INTERPRET", "1")
    if case == "pallas_strip":
        backend, width, hw, scales = "pallas_strip", 0.125, (32, 32), tuple([0.25] * 13)
    else:
        wide = tuple((n, ch and 2 * ch) for n, ch in CONV1_2_MINI)  # 128, 128, 256, ...
        for mod in (jvgg, tvgg):
            monkeypatch.setattr(mod, "VGG16_LAYOUT", wide)
        backend, width, hw, scales = "pallas", 0.5, (12, 16), (0.5, 0.125, 0.125, 0.125)
    x = np.random.RandomState(8).uniform(-60, 60, (2,) + hw + (3,)).astype(np.float32)
    outs = {}
    for chain_from in ("conv2_2", "conv1_2"):
        jt = jvgg.VGG16Trunk(dtype=jnp.bfloat16, width=width, int8_mode=True,
                             int8_scales=scales, int8_backend=backend, int8_chain_from=chain_from)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            tt = tvgg.VGG16Trunk(width=width, int8_mode=True, int8_scales=scales,
                                 int8_backend=backend, int8_chain_from=chain_from)
        assert sum("INT8_CHAIN_FROM" in str(w.message) for w in rec) == (chain_from == "conv1_2")
        assert tt.int8_bf16_prefix == ("conv1_1", "conv1_2", "conv2_1")
        outs[chain_from] = _trunk_pair(x, jt, tt, 4)
    for i in range(2):  # the port's, then the reference's
        np.testing.assert_array_equal(outs["conv1_2"][i], outs["conv2_2"][i])
    _assert_trunk_close(*outs["conv1_2"])


# -- calibration -------------------------------------------------------------


def _nets(overrides):
    cfg = cfg_from_dict(Config(), overrides)
    jnet = japi.build_az_net(cfg)
    sd = params_from_flax(_np_tree(jnet.params))
    return cfg, jnet, tapi.build_az_net(cfg, state_dict=sd, device="cpu")


def test_calibration_matches():
    cfg, jnet, tnet = _nets(SMALL)
    images = np.random.RandomState(0).uniform(-120, 120, (3, 64, 64, 3)).astype(np.float32)
    want = jquant.calibrate_trunk_int8(jnet, images, batch_size=2)
    got = tquant.calibrate_trunk_int8(tnet, images, batch_size=2)
    assert len(got) == len(tquant.CONV_NAMES) == 13
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(tquant.calibrate_trunk_int8(tnet, images, percentile=99.0),
                               jquant.calibrate_trunk_int8(jnet, images, percentile=99.0),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(tquant.calibrate_head_int8(tnet, images, want),
                               jquant.calibrate_head_int8(jnet, images, want),
                               rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="not int8"):
        tquant.calibrate_trunk_int8(
            tapi.build_az_net(tquant.with_int8_scales(cfg, want), device="cpu"), images)


@pytest.mark.parametrize("levels", [0, 1, 2])
@pytest.mark.parametrize("div_overlap", [0.0, 0.25])
def test_division_tree_regions_matches(levels, div_overlap):
    for hw, offset in (((64, 96), 1.0), ((600, 803), 0.0)):
        want = jdivision_tree_regions(hw, levels, offset=offset, div_overlap=div_overlap)
        got = division_tree_regions(hw, levels, offset=offset, div_overlap=div_overlap)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# -- int8 ROI align and the int8 head ----------------------------------------


@pytest.mark.parametrize("w_first", [False, True])
def test_roi_align_int8_matches(w_first):
    rng = np.random.RandomState(11)
    feat = rng.randint(-127, 128, (9, 14, 24)).astype(np.int8)
    xy = rng.uniform(0, 180, (40, 2)).astype(np.float32)
    rois = np.concatenate([xy, xy + rng.uniform(4, 120, (40, 2)).astype(np.float32)], 1)
    want = np.asarray(jroi_align_int8(jnp.asarray(feat), jnp.asarray(rois), 1 / 16.0,
                                          7, w_first=w_first))
    got = roi_align_int8(torch.from_numpy(feat), torch.from_numpy(rois), 1 / 16.0, 7,
                         w_first=w_first)
    assert got.dtype == torch.int8 and got.shape == (40, 7, 7, 24)
    _assert_codes_close(got.numpy(), want)


def _int8_cfg(cfg, scales, head_scales, **model):
    cfg8 = tquant.with_int8_scales(cfg, scales, head_scales)
    return dataclasses.replace(cfg8, MODEL=dataclasses.replace(cfg8.MODEL, **model))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_int8_head_matches(dtype):
    """Int8 fc stack (bf16-rounded fc6/fc7 quantized per column) on the same
    int8 features: logits against JAX roi_forward, with the int8 trunk and
    with a bf16 trunk plus int8 heads (the reference bench's int8_heads)."""
    cfg, jnet, tnet = _nets(SMALL)
    if dtype == "int8":
        cfg8 = _int8_cfg(cfg, tuple(2.0 ** -k for k in range(2, 15)), (0.05, 0.02),
                         INT8_ROI=True)
    else:
        cfg8 = dataclasses.replace(cfg, MODEL=dataclasses.replace(
            cfg.MODEL, COMPUTE_DTYPE="bfloat16", INT8_HEAD_SCALES=(0.05, 0.02), INT8_ROI=True))
    jnet8 = japi.build_az_net(cfg8, params=jnet.params)
    tnet8 = tapi.build_az_net(cfg8, state_dict=tnet.params, device="cpu")
    rng = np.random.RandomState(4)
    feat = rng.randint(0, 80, (6, 8, 64)).astype(np.int8)
    xy = rng.uniform(0, 60, (20, 2)).astype(np.float32)
    rois = np.concatenate([xy, xy + rng.uniform(8, 60, (20, 2)).astype(np.float32)], 1)
    want = jnet8.model.apply(japi._cast_inference_params(jnet8.params, cfg8),
                             jnp.asarray(feat), jnp.asarray(rois), method="roi_forward")
    with torch.no_grad():
        got = tnet8.model.roi_forward(torch.from_numpy(feat), torch.from_numpy(rois))
    for key in ("zoom", "adj_score", "adj_delta"):
        w = np.asarray(want[key], np.float32)
        assert np.abs(w).max() > 0.01
        np.testing.assert_allclose(got[key].numpy(), w, atol=1e-6, rtol=0)


# -- the int8 propose path ---------------------------------------------------


def _int8_nets(monkeypatch, backend="pallas"):
    """JAX and port int8 nets from one JAX init, with scales calibrated by the
    JAX package on its bf16 net (INT8_ROI on, as the reference bench)."""
    monkeypatch.setenv("AZNET_INT8_INTERPRET", "1")
    overrides = dict(SMALL, MODEL=dict(SMALL["MODEL"], COMPUTE_DTYPE="bfloat16"))
    cfg, jnet, tnet = _nets(overrides)
    calib = np.random.RandomState(7).randint(0, 256, (2, 64, 128, 3)).astype(np.float32)
    calib -= np.asarray(cfg.PIXEL_MEANS, np.float32)
    scales = jquant.calibrate_trunk_int8(jnet, calib, batch_size=2)
    head_scales = jquant.calibrate_head_int8(jnet, calib, scales)
    cfg8 = _int8_cfg(cfg, scales, head_scales, INT8_ROI=True, INT8_BACKEND=backend)
    return cfg8, japi.build_az_net(cfg8, params=jnet.params), tapi.build_az_net(
        cfg8, state_dict=tnet.params, device="cpu")


def _assert_props(got, want):
    """``[N, 5]`` proposals of one image (the module docstring's bound)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(np.sort(got[:, 4]), np.sort(want[:, 4]), atol=1e-4, rtol=0)
    near = np.abs(got[:, None, :4] - want[None, :, :4]).max(-1).min(-1) <= 0.5
    assert near.mean() >= 0.8, near


def test_int8_im_propose_matches(monkeypatch):
    cfg8, jnet, tnet = _int8_nets(monkeypatch)
    for seed, hw in ((0, (100, 150)), (2, (90, 140))):
        im = np.random.RandomState(seed).randint(0, 256, hw + (3,)).astype(np.uint8)
        got = tapi.im_propose(tnet, im)
        assert 0 < got.shape[0] <= 10
        _assert_props(got, japi.im_propose(jnet, im))


def test_int8_make_propose_batch_matches(monkeypatch):
    _assert_propose_batch_matches(*_int8_nets(monkeypatch, backend="pallas_strip"))


def test_int8_xla_make_propose_batch_matches(monkeypatch):
    """``INT8_BACKEND='xla'`` through ``make_propose_batch``, at the bounds of
    the ``'pallas_strip'`` test above."""
    _assert_propose_batch_matches(*_int8_nets(monkeypatch, backend="xla"))


def _assert_propose_batch_matches(cfg8, jnet, tnet):
    ims = np.random.RandomState(5).randint(0, 256, (2, 96, 128, 3)).astype(np.uint8)
    want = jax.jit(japi.make_propose_batch(jnet.model, cfg8, (64, 128)))(
        jnet.params, jnp.asarray(ims))
    got = tapi.make_propose_batch(tnet.model, cfg8, (64, 128))(torch.from_numpy(ims))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for i in range(2):
        n = int(got[2][i].sum())
        assert n > 0
        _assert_props(torch.cat([got[0][i], got[1][i, :, None]], -1)[:n],
                      np.concatenate([np.asarray(want[0][i]),
                                      np.asarray(want[1][i])[:, None]], -1)[:n])


# -- the f32 masters and the guards ------------------------------------------


def test_net_params_are_the_float32_masters():
    """A bf16 net returns the float32 state dict it was built from, bit for
    bit; an int8 net rebuilt from it quantizes the float32 trunk weights."""
    overrides = dict(SMALL, MODEL=dict(SMALL["MODEL"], COMPUTE_DTYPE="bfloat16"))
    cfg = cfg_from_dict(Config(), overrides)
    sd = tapi.build_az_net(dataclasses.replace(
        cfg, MODEL=dataclasses.replace(cfg.MODEL, COMPUTE_DTYPE="float32")), seed=9,
        device="cpu").params
    net = tapi.build_az_net(cfg, state_dict=sd, device="cpu")
    assert next(net.model.parameters()).dtype == torch.bfloat16
    assert net.params.keys() == sd.keys()
    for k, v in sd.items():
        assert net.params[k].dtype == torch.float32
        assert torch.equal(net.params[k], v), k
    net8 = tapi.build_az_net(tquant.with_int8_scales(cfg, [0.1] * 13), state_dict=net.params,
                             device="cpu")
    w = sd["trunk.conv3_1.weight"]
    q, s = tconv.pack_weights_9(w)
    layer = net8.model.trunk._int8_layers["conv3_1"]
    assert torch.equal(layer.w_k, tconv.kernel_layout(q)) and torch.equal(layer.s_w, s)
    q16, s16 = tconv.pack_weights_9(w.to(torch.bfloat16).float())
    assert not torch.equal(layer.s_w, s16)
    assert net8.model.trunk.conv3_1.weight.dtype == torch.float32
    assert net8.model.head.fc.fc6.weight.dtype == torch.bfloat16


@pytest.mark.parametrize("override,exc,match", [
    (dict(COMPUTE_DTYPE="int8", INT8_CHAIN_FROM="conv12"), ValueError, "INT8_CHAIN_FROM"),
    (dict(COMPUTE_DTYPE="int8", BACKBONE="smallnet"), ValueError, "vgg16 and resnet50"),
    (dict(COMPUTE_DTYPE="int8", INT8_BACKEND="cuda"), ValueError, "INT8_BACKEND"),
])
def test_int8_guards(override, exc, match):
    with pytest.raises(exc, match=match):
        taznet.AZNet(dataclasses.replace(ModelConfig(WIDTH=0.125, FC_DIM=16), **override))


def test_int8_requires_scales():
    cfg = cfg_from_dict(Config(), {"MODEL": {"WIDTH": 0.125, "FC_DIM": 16,
                                             "COMPUTE_DTYPE": "int8"}})
    net = tapi.build_az_net(cfg, device="cpu")
    with pytest.raises(ValueError, match="INT8_SCALES"):
        net.model.features(torch.zeros((1, 64, 64, 3)))


def test_int8_port_runs_without_jax():
    """The card's machine has no JAX: with ``jax`` and ``flax`` made
    unimportable, calibrate a small bf16 VGG-16 net, rebuild it int8 (int8
    heads and ROI align) and propose."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax"):
            sys.modules[name] = None
        import dataclasses
        import numpy as np, torch
        torch.set_num_threads(1)
        from aznet_tpu_torch.config import Config, cfg_from_dict
        from aznet_tpu_torch.api import build_az_net, im_propose
        from aznet_tpu_torch.ops.quant import (calibrate_head_int8, calibrate_trunk_int8,
                                               with_int8_scales)
        cfg = cfg_from_dict(Config(), {
            "MODEL": {"WIDTH": 0.125, "FC_DIM": 32, "NUM_TEMPLATES": 5},
            "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 2,
                     "NUM_PROPOSALS": 10},
            "TEST": {"SCALES": [64], "MAX_SIZE": 128}})
        net = build_az_net(cfg, device="cpu")
        calib = np.random.RandomState(7).uniform(-120, 120, (2, 64, 128, 3))
        scales = calibrate_trunk_int8(net, calib, batch_size=2)
        cfg8 = with_int8_scales(cfg, scales, calibrate_head_int8(net, calib, scales))
        cfg8 = dataclasses.replace(cfg8, MODEL=dataclasses.replace(cfg8.MODEL, INT8_ROI=True))
        im = np.random.RandomState(0).randint(0, 256, (100, 150, 3)).astype(np.uint8)
        dets = im_propose(build_az_net(cfg8, state_dict=net.params, device="cpu"), im)
        assert dets.shape[1] == 5 and 0 < dets.shape[0] <= 10, dets.shape
        assert np.isfinite(dets).all()
        assert not any(m.split(".")[0] in ("jax", "flax", "aznet_tpu") for m in sys.modules
                       if sys.modules[m] is not None)
        print("OK", dets.shape[0])
    """)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK")
