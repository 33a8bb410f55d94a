"""Port parity, ops: boxes, IoU, templates, preprocessing, ROI align.

Same NumPy inputs through the JAX reference (CPU) and ``aznet_tpu_torch``.
Tolerances: exact where the arithmetic is elementwise and identical; f32
1e-6 relative where transcendental functions (exp/log) may differ by an ulp;
1e-3 absolute on 0..255 pixels for the resize matmuls and 1e-5 for ROI
align, whose reductions run in another order.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aznet_tpu import api as japi
from aznet_tpu.config import Config, cfg_from_dict
from aznet_tpu.ops import boxes as jboxes
from aznet_tpu.ops import iou as jiou
from aznet_tpu.ops import preprocess as jprep
from aznet_tpu.search import templates as jtpl
from aznet_tpu_torch import api as tapi
from aznet_tpu_torch.ops import boxes as tboxes
from aznet_tpu_torch.ops import iou as tiou
from aznet_tpu_torch.ops import preprocess as tprep
from aznet_tpu_torch.ops import roi_pool as troi
from aznet_tpu_torch.search import templates as ttpl

# The package re-exports a function named roi_pool over the module's name.
jroi = importlib.import_module("aznet_tpu.ops.roi_pool")

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _boxes(rng, n, lo=0.0, hi=400.0):
    xy = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    wh = rng.uniform(1.0, 150.0, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], axis=1)


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("offset", [1.0, 0.0])
def test_box_codecs_match(offset):
    rng = np.random.RandomState(0)
    ex, gt = _boxes(rng, 64), _boxes(rng, 64)
    _close(tboxes.bbox_transform(torch.from_numpy(ex), torch.from_numpy(gt), offset),
           jboxes.bbox_transform(jnp.asarray(ex), jnp.asarray(gt), offset))
    deltas = rng.uniform(-6, 6, (64, 5, 4)).astype(np.float32)
    for d, clip in ((deltas, 4.135166556742356), (deltas.reshape(64, 20), None)):
        _close(tboxes.bbox_transform_inv(torch.from_numpy(ex), torch.from_numpy(d), offset, clip=clip),
               jboxes.bbox_transform_inv(jnp.asarray(ex), jnp.asarray(d), offset, clip=clip),
               atol=1e-3)  # exp of |d| <= 6 times ~150 px: 1e-6 relative
    big = _boxes(rng, 64, lo=-100.0, hi=600.0)
    _close(tboxes.clip_boxes(torch.from_numpy(big), (torch.tensor(300.0), 500), offset),
           jboxes.clip_boxes(jnp.asarray(big), (300.0, 500), offset), rtol=0, atol=0)


def test_bbox_overlaps_matches():
    rng = np.random.RandomState(1)
    a, b = _boxes(rng, 50, hi=200.0), _boxes(rng, 40, hi=200.0)
    for offset in (1.0, 0.0):
        _close(tiou.bbox_overlaps(torch.from_numpy(a), torch.from_numpy(b), offset),
               jiou.bbox_overlaps(jnp.asarray(a), jnp.asarray(b), offset))


def test_template_tables_equal_reference():
    for k in (5, 11):
        np.testing.assert_array_equal(ttpl.adjacency_templates_np(k), jtpl.adjacency_templates_np(k))
    for ov in (0.0, 0.1):
        np.testing.assert_array_equal(ttpl.division_table(ov), jtpl.division_table(ov))
    with pytest.raises(ValueError):
        ttpl.adjacency_templates_np(12)


def test_template_boxes_and_division_match():
    rng = np.random.RandomState(2)
    regions = _boxes(rng, 30)
    for offset in (1.0, 0.0):
        _close(ttpl.template_boxes(torch.from_numpy(regions), ttpl.adjacency_templates(11), offset),
               jtpl.template_boxes(jnp.asarray(regions), jtpl.adjacency_templates(11), offset))
        for ov in (0.0, 0.25):
            _close(ttpl.divide_regions(torch.from_numpy(regions), ov, offset),
                   jtpl.divide_regions(jnp.asarray(regions), ov, offset))


def test_compute_scale_and_canvas_match():
    cfg = Config()
    small = cfg_from_dict(cfg, {"TEST": {"SCALES": [64], "MAX_SIZE": 128}})
    for h, w in ((375, 500), (500, 375), (100, 150), (333, 1000), (600, 600), (97, 61)):
        for target, max_size in ((600, 1000), (64, 128), (800, 1333)):
            assert tprep.compute_scale(h, w, target, max_size) == \
                jprep.compute_scale(h, w, target, max_size)
        for c in (cfg, small):
            assert tapi._canvas_for(h, w, c) == japi._canvas_for(h, w, c)


@pytest.mark.parametrize("padded", [False, True])
def test_preprocess_image_matches(padded):
    rng = np.random.RandomState(3)
    im = rng.randint(0, 256, (75, 100, 3)).astype(np.uint8)
    means = Config().PIXEL_MEANS
    kw = {}
    if padded:  # zero-padded raw image with dynamic true extents and scale
        raw = np.zeros((96, 128, 3), np.uint8)
        raw[:75, :100] = im
        im = raw
        scale = tprep.compute_scale(75, 100, 64, 128)
        kw_t = dict(src_hw=torch.tensor([75.0, 100.0]), scale=torch.tensor(scale))
        kw = dict(src_hw=jnp.asarray([75.0, 100.0]), scale=jnp.float32(scale))
    else:
        kw_t = {}
    got, s_t, (vh_t, vw_t) = tprep.preprocess_image(
        torch.from_numpy(im), means, 64, 128, 64, 128, **kw_t)
    want, s_j, (vh_j, vw_j) = jprep.preprocess_image(
        jnp.asarray(im), means, 64, 128, 64, 128, **kw)
    _close(got, want, rtol=0, atol=1e-3)
    assert float(s_t) == float(s_j)
    assert (int(vh_t), int(vw_t)) == (int(vh_j), int(vw_j))


def test_preprocess_bf16_blob_matches():
    """bf16 blob: the resize matmuls run in bf16 with f32 accumulation on
    both sides; compare at bf16 resolution (2 units on |x| <= 160)."""
    im = np.random.RandomState(4).randint(0, 256, (75, 100, 3)).astype(np.uint8)
    means = Config().PIXEL_MEANS
    got, _, _ = tprep.preprocess_image(torch.from_numpy(im), means, 64, 128, 64, 128,
                                       dtype=torch.bfloat16)
    want, _, _ = jprep.preprocess_image(jnp.asarray(im), means, 64, 128, 64, 128,
                                        dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), rtol=0, atol=2.0)


@pytest.mark.parametrize("w_first", [False, True])
def test_roi_align_both_orders_match(w_first):
    rng = np.random.RandomState(5)
    feat = rng.randn(9, 13, 16).astype(np.float32)
    rois = _boxes(rng, 300, hi=180.0)  # > chunk of 256: two chunks
    got = troi.roi_align(torch.from_numpy(feat), torch.from_numpy(rois), 1 / 16.0, 7,
                         w_first=w_first)
    want = jroi.roi_align(jnp.asarray(feat), jnp.asarray(rois), 1 / 16.0, 7, w_first=w_first)
    assert got.shape == (300, 7, 7, 16)
    _close(got, want, rtol=0, atol=1e-5)


def test_contract_w_first_rule_matches():
    for h, w, c, item in ((38, 50, 512, 2), (68, 120, 1024, 2), (120, 68, 1024, 4),
                          (40, 90, 1024, 4)):
        assert troi._contract_w_first(h, w, c, item) == \
            jroi._contract_w_first(h, w, c, item, None)
