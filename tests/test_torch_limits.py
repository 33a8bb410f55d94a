"""The kernel wrappers' limits against their JAX counterparts' domains: does
the port raise where the JAX package answers?

Repaired (the JAX package answers, and now the port does, the same way):
- ``ops/conv_int8.py::conv3x3_int8_reference`` above 1040 input channels
  (its float32 tap sums are taken over 1040 channels at a time and added in
  int32), against ``conv3x3_int8_pallas`` in interpret mode at C = 1056,
  bit for bit on integer grids;
- ``ops/roi_pool.py::roi_align_int8`` over a map wider than 1040 cells
  (the same chunking of its integer sums), against the reference's
  ``roi_align_int8`` at the existing test's bound (at most one code apart,
  on at most 0.1% of the codes).

Still raising on the card, each kept here with the case where the JAX
package answers (ROADMAP.md, Queue C); the card tests that show the
wrappers raising are in ``tests/test_torch_cuda.py``:
- the fused conv1 kernels take at most 64 channels (``kernel_layout``,
  ``kernel_layout_f32``); the Pallas kernel pads C to its 128 lanes;
- the float32 fused conv1 kernel takes C a multiple of 8;
- the ROI-align kernel takes ``pool_size`` <= 16 (``MAX_POOL``);
- the int8 conv kernel takes C and Co multiples of 8 (VGG-16 at a WIDTH
  whose channels are not, 0.3 say); the Pallas strip kernel answers at C=20.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aznet_tpu.ops.pallas import conv1_kernel as jconv1
from aznet_tpu.ops.pallas import roi_kernel as jroi_kernel
from aznet_tpu.ops.pallas.conv_int8_kernel import conv3x3_int8_pallas
from aznet_tpu.ops.roi_pool import roi_align_int8 as jroi_align_int8
from aznet_tpu_torch.ops import conv1_fused as tconv1
from aznet_tpu_torch.ops import conv_int8 as tconv
from aznet_tpu_torch.ops.cuda import roi_align_kernel

troi = importlib.import_module("aznet_tpu_torch.ops.roi_pool")

torch.set_num_threads(2)


def test_plain_int8_conv_above_1040_channels():
    rng = np.random.RandomState(1056)
    c, co = 1056, 16
    x = rng.randint(-5, 6, (1, 4, 6, c)).astype(np.int8)
    wts = rng.randint(-3, 4, (9, c, co)).astype(np.int8)
    bias = rng.randint(-2, 3, (co,)).astype(np.float32)
    sw = np.ones((co,), np.float32)
    want = conv3x3_int8_pallas(jnp.asarray(x), 1.0, jnp.asarray(wts), jnp.asarray(sw),
                               jnp.asarray(bias), s_out=64.0, interpret=True)
    layer = tconv.Int8Conv(tconv.kernel_layout(torch.tensor(wts)), torch.tensor(sw),
                           torch.tensor(bias))
    got = tconv.conv3x3_int8_reference(torch.from_numpy(x), 1.0, layer, 64.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int((got != 0).sum()) < got.numel()


@pytest.mark.parametrize("long_axis", ["h", "w"])
def test_roi_align_int8_above_1040_cells(long_axis):
    """The first (integer) contraction runs over the long axis: H first on a
    1100-row map, W first on a 1100-column one."""
    rng = np.random.RandomState(1100)
    w_first = long_axis == "w"
    feat = rng.randint(-127, 128, (6, 1100, 8) if w_first else (1100, 6, 8)).astype(np.int8)
    lo = rng.uniform(0, 16 * 900, 24)
    span = np.stack([lo, lo + rng.uniform(16 * 100, 16 * 190, 24)], 1)
    short = np.tile([0.0, 16 * 5.0], (24, 1))  # the short axis: the whole map
    x, y = (span, short) if w_first else (short, span)
    rois = np.stack([x[:, 0], y[:, 0], x[:, 1], y[:, 1]], 1).astype(np.float32)
    want = np.asarray(jroi_align_int8(jnp.asarray(feat), jnp.asarray(rois), 1 / 16.0, 7,
                                      w_first=w_first))
    got = troi.roi_align_int8(torch.from_numpy(feat), torch.from_numpy(rois), 1 / 16.0, 7,
                              w_first=w_first).numpy()
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())
    assert np.abs(want.astype(np.int32)).max() > 20


def _conv1_case(c, dtype=jnp.bfloat16):
    rng = np.random.RandomState(c)
    x = rng.uniform(-1, 1, (1, 8, 6, 3)).astype(np.float32)
    w11 = (rng.randn(3, 3, 3, c) * 0.2).astype(np.float32)
    w12 = (rng.randn(3, 3, c, c) * 0.05).astype(np.float32)
    b11, b12 = np.zeros(c, np.float32), np.zeros(c, np.float32)
    out = jconv1.fused_conv1_pool(jnp.asarray(x, dtype), jnp.asarray(w11), jnp.asarray(b11),
                                  jnp.asarray(w12), jnp.asarray(b12), interpret=True)
    return torch.from_numpy(w12).permute(3, 2, 0, 1), np.asarray(out, np.float32)


def test_fused_conv1_above_64_channels_answers_in_jax_only():
    w12, want = _conv1_case(96)
    assert want.shape == (1, 4, 3, 96) and np.isfinite(want).all()
    with pytest.raises(ValueError, match="at most 64 channels"):
        tconv1.kernel_layout(w12)
    with pytest.raises(ValueError, match="at most 64 channels"):
        tconv1.kernel_layout_f32(w12)


def test_fused_conv1_f32_channels_not_a_multiple_of_8_answer_in_jax_only():
    w12, want = _conv1_case(20, jnp.float32)
    assert want.shape == (1, 4, 3, 20) and np.isfinite(want).all()
    with pytest.raises(ValueError, match="multiple of 8"):
        tconv1.kernel_layout_f32(w12)


def test_roi_align_above_16_bins_answers_in_jax_only():
    rng = np.random.RandomState(17)
    feat = rng.randn(12, 14, 8).astype(np.float32)
    lo = rng.uniform(0, 100, (5, 2)).astype(np.float32)
    rois = np.concatenate([lo, lo + rng.uniform(20, 90, (5, 2)).astype(np.float32)], 1)
    want = np.asarray(jroi_kernel.roi_align_pallas(jnp.asarray(feat), jnp.asarray(rois),
                                                   1 / 16.0, 17, interpret=True))
    assert want.shape == (5, 17, 17, 8) and np.isfinite(want).all()
    assert roi_align_kernel.MAX_POOL < 17  # roi_align_cuda raises above it
    got = troi.roi_align_fused_reference(torch.from_numpy(feat), torch.from_numpy(rois),
                                         1 / 16.0, 17, False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)  # the CPU path answers


def test_int8_conv_channels_not_a_multiple_of_8_answer_in_jax():
    """The JAX strip kernel answers at C = Co = 20, and so does the port's
    plain version (the CPU path), bit for bit; the card kernel raises."""
    rng = np.random.RandomState(20)
    c = co = 20
    x = rng.randint(-5, 6, (1, 4, 6, c)).astype(np.int8)
    wts = rng.randint(-3, 4, (9, c, co)).astype(np.int8)
    bias = rng.randint(-2, 3, (co,)).astype(np.float32)
    sw = np.ones((co,), np.float32)
    want = conv3x3_int8_pallas(jnp.asarray(x), 1.0, jnp.asarray(wts), jnp.asarray(sw),
                               jnp.asarray(bias), s_out=64.0, interpret=True)
    layer = tconv.Int8Conv(tconv.kernel_layout(torch.tensor(wts)), torch.tensor(sw),
                           torch.tensor(bias))
    got = tconv.conv3x3_int8_reference(torch.from_numpy(x), 1.0, layer, 64.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
