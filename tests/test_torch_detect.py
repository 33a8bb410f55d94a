"""Port parity, the detection side: ``FRCNNHead``, ``FRCNN``, ``im_detect``
(one and two ``BBOX_ITER`` passes, one scale and the image pyramid), the
batched detect, the shared-trunk fused propose + detect program, and the
config tree. The config is a small VGG-16 (``WIDTH`` 0.25: conv1 has 16
channels) with ``POOLING_MODE='align_pallas'`` and ``FUSE_CONV1``, weights
converted from the JAX net. The JAX side runs ``roi_align_pallas`` in
interpret mode (patched in, as its API does not ask for it on the CPU) and
conv1 unfused (its fused gate needs a TPU); the port runs the plain versions
of both kernels.

Tolerances, with their reasons: the head alone in f32 to 1e-4 of the
output's max |x| (``tests/test_torch_models.py``), its int8 stack to 1e-6.
The f32 path: softmax scores to 1e-5, boxes to 2e-3 pixels in original
coordinates (the propose tests' bounds). The bf16 path: softmax scores to
1e-2 (measured 7.2e-3 with two BBOX_ITER passes: the tests scale
``cls_score`` by 300, which sharpens the softmax) and boxes to 0.5 pixel:
the fused conv1 block adds the conv1_1 bias after a bf16 rounding and the
JAX trunk before it, so the trunks differ by up to 2e-2 of their max
(``tests/test_torch_kernels3.py``). A padded image against the same image
unpadded: 1e-5 relative (the resize contracts over another width, which
reorders its f32 sums).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aznet_tpu import api as japi
from aznet_tpu import config as jconfig
from aznet_tpu.models.frcnn import FRCNN as JFRCNN
from aznet_tpu.models.heads import FRCNNHead as JFRCNNHead
from aznet_tpu.ops.pallas import roi_kernel as jroi_kernel
from aznet_tpu_torch import api as tapi
from aznet_tpu_torch import config as tconfig
from aznet_tpu_torch.models.frcnn import FRCNN
from aznet_tpu_torch.models.heads import FRCNNHead
from aznet_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OVERRIDES = {
    "MODEL": {"WIDTH": 0.25, "FC_DIM": 32, "NUM_TEMPLATES": 5, "NUM_CLASSES": 5,
              "POOLING_MODE": "align_pallas", "FUSE_CONV1": True},
    "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 2, "NUM_PROPOSALS": 10},
    "TEST": {"SCALES": [64], "MAX_SIZE": 128},
}
CANVAS = (64, 128)
TOL = {"float32": (1e-5, 2e-3), "bfloat16": (1e-2, 0.5)}  # (scores, boxes)


@pytest.fixture(autouse=True)
def _jax_align_pallas_interpret(monkeypatch):
    orig = jroi_kernel.roi_align_pallas
    monkeypatch.setattr(jroi_kernel, "roi_align_pallas", functools.partial(orig, interpret=True))


def _cfgs(dtype="float32", **test):
    over = dict(OVERRIDES, MODEL=dict(OVERRIDES["MODEL"], COMPUTE_DTYPE=dtype),
                TEST=dict(OVERRIDES["TEST"], **test))
    return (jconfig.cfg_from_dict(jconfig.Config(), over),
            tconfig.cfg_from_dict(tconfig.Config(), over))


def _np_tree(params):
    return jax.tree_util.tree_map(np.array, params)


def _frcnn_nets(dtype="float32", **test):
    """JAX and port detectors from one JAX init; ``cls_score`` scaled up so
    the class scores are far from uniform (the second BBOX_ITER pass then
    selects the same class in both packages)."""
    jcfg, tcfg = _cfgs(dtype, **test)
    tree = _np_tree(japi.build_frcnn_net(jcfg).params)
    tree["params"]["head"]["cls_score"]["kernel"] *= 300.0
    jnet = japi.build_frcnn_net(jcfg, params=tree)
    return jnet, tapi.build_frcnn_net(tcfg, state_dict=params_from_flax(tree), device="cpu")


def _image_boxes(seed, hw=(100, 150), r=12):
    rng = np.random.RandomState(seed)
    im = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    xy = rng.uniform(0, 0.7, (r, 2)) * np.array([hw[1], hw[0]])
    wh = rng.uniform(12, 60, (r, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [hw[1] - 1, hw[0] - 1])], 1)
    return im, boxes.astype(np.float32)


def _assert_dets(got, want, dtype, n_classes=5):
    s_tol, b_tol = TOL[dtype]
    (gs, gb), (ws, wb) = [tuple(np.asarray(t, np.float32) for t in x) for x in (got, want)]
    assert gs.shape == ws.shape and gb.shape == wb.shape, (gs.shape, ws.shape, gb.shape, wb.shape)
    assert gs.shape[-1] == n_classes and gb.shape[-1] == 4 * n_classes
    np.testing.assert_allclose(gs, ws, atol=s_tol, rtol=0)
    np.testing.assert_allclose(gb, wb, atol=b_tol, rtol=0)
    np.testing.assert_allclose(gs.sum(-1), 1.0, atol=1e-5)


def test_config_trees_equal():
    assert tconfig.cfg_to_dict(tconfig.Config()) == jconfig.cfg_to_dict(jconfig.Config())
    args = ["SEAR.NUM_PROPOSALS", "100", "MODEL.POOLING_MODE", "align_pallas",
            "TEST.SCALES", "[480, 600]", "MODEL.FUSE_CONV1", "True"]
    assert (tconfig.cfg_to_dict(tconfig.cfg_from_list(tconfig.Config(), args))
            == jconfig.cfg_to_dict(jconfig.cfg_from_list(jconfig.Config(), args)))
    with pytest.raises(KeyError, match="unknown config key"):
        tconfig.cfg_from_dict(tconfig.Config(), {"MODEL": {"NOPE": 1}})


@pytest.mark.parametrize("int8_scales", [(), (0.05, 0.02)])
def test_frcnn_head_matches(int8_scales):
    pooled = np.random.RandomState(3).uniform(0, 2, (20, 7, 7, 16)).astype(np.float32)
    # The int8 stack exits fc7 in the head's dtype: bf16, as in every config
    # that has int8 heads.
    jm = JFRCNNHead(num_classes=7, fc_dim=64, int8_scales=int8_scales,
                    dtype=jnp.bfloat16 if int8_scales else jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(pooled))
    want = jm.apply(params, jnp.asarray(pooled))
    head = FRCNNHead(7 * 7 * 16, 7, 64, int8_scales=int8_scales)
    head.load_state_dict(params_from_flax(_np_tree(params)))
    if int8_scales:
        head.fc.prepare_int8()
    with torch.no_grad():
        got = head.eval()(torch.from_numpy(pooled))
    for key, n in (("cls_score", 7), ("bbox_pred", 28)):
        w = np.asarray(want[key], np.float32)
        assert got[key].dtype == torch.float32 and got[key].shape == (20, n)
        tol = 1e-6 if int8_scales else 1e-4 * np.abs(w).max()
        np.testing.assert_allclose(got[key].numpy(), w, atol=tol, rtol=0)


def test_frcnn_roi_forward_matches():
    jcfg, tcfg = _cfgs()
    rng = np.random.RandomState(4)
    images = rng.uniform(-50, 50, (1, 64, 96, 3)).astype(np.float32)
    xy = rng.uniform(0, 60, (30, 2)).astype(np.float32)
    rois = np.concatenate([xy, xy + rng.uniform(8, 40, (30, 2)).astype(np.float32)], 1)
    jm = JFRCNN(model_cfg=jcfg.MODEL)
    params = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.asarray(images), jnp.asarray(rois))
    feat = jm.apply(params, jnp.asarray(images), method="features")[0]
    want = jm.apply(params, feat, jnp.asarray(rois), method="roi_forward")
    tm = FRCNN(tcfg.MODEL)
    tm.load_state_dict(params_from_flax(_np_tree(params)))
    with torch.no_grad():
        tfeat = tm.eval().features(torch.from_numpy(images))[0]
        got = tm.roi_forward(tfeat, torch.from_numpy(rois))
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(feat), atol=1e-4 * np.abs(feat).max())
    for key in ("cls_score", "bbox_pred"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bbox_iter", [1, 2])
def test_im_detect_matches(dtype, bbox_iter):
    jnet, tnet = _frcnn_nets(dtype, BBOX_ITER=bbox_iter)
    for seed, hw in ((0, (100, 150)), (1, (90, 140))):
        im, boxes = _image_boxes(seed, hw)
        got = tapi.im_detect(tnet, im, boxes)
        assert got[0].dtype == np.float32
        _assert_dets(got, japi.im_detect(jnet, im, boxes), dtype)
        assert (got[1][:, 0::2] >= 0).all() and (got[1][:, 0::2] <= hw[1] - 1).all()
        assert (got[1][:, 1::2] >= 0).all() and (got[1][:, 1::2] <= hw[0] - 1).all()


def test_im_detect_pyramid_matches():
    """Two scales: rois split between them by the 224**2 area rule."""
    jnet, tnet = _frcnn_nets(SCALES=[48, 64])
    im, boxes = _image_boxes(2, r=16)
    # Boxes over ~396 px a side (past the image) go to the smaller scale.
    boxes[:4, 2:] = boxes[:4, :2] + np.array([[420], [440], [480], [500]], np.float32)
    areas = np.prod(boxes[:, 2:] - boxes[:, :2] + 1.0, axis=1)
    scales = np.array([[48 / 100.0], [64 / 100.0]])  # the 100x150 image's two scales
    assign = np.abs(areas * scales ** 2 - 224.0 ** 2).argmin(0)
    assert (assign == 0).sum() == 4 and (assign == 1).sum() == 12
    _assert_dets(tapi.im_detect(tnet, im, boxes), japi.im_detect(jnet, im, boxes), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_detect_batch_padded_matches(dtype):
    jnet, tnet = _frcnn_nets(dtype, BBOX_ITER=2)
    hws = [(100, 150), (80, 120)]
    raw = np.zeros((2, 100, 160, 3), np.uint8)
    boxes = []
    for i, hw in enumerate(hws):
        im, b = _image_boxes(3 + i, hw)
        raw[i, :hw[0], :hw[1]] = im
        boxes.append(b)
    boxes = np.stack(boxes)
    src_hw = np.asarray(hws, np.float32)
    scales = np.asarray([tapi.compute_scale(h, w, 64, 128) for h, w in hws], np.float32)
    want = jax.jit(japi.make_detect_batch_padded(jnet.model, jnet.cfg, CANVAS))(
        jnet.params, jnp.asarray(raw), jnp.asarray(src_hw), jnp.asarray(scales),
        jnp.asarray(boxes))
    got = tapi.make_detect_batch_padded(tnet.model, tnet.cfg, CANVAS)(
        torch.from_numpy(raw), torch.from_numpy(src_hw), torch.from_numpy(scales),
        torch.from_numpy(boxes))
    _assert_dets(got, want, dtype)
    # The unpadded batch gives the padded call's rows for the full-size image.
    one = tapi.make_detect_batch(tnet.model, tnet.cfg, CANVAS)(
        torch.from_numpy(raw[:1, :100, :150].copy()), torch.from_numpy(boxes[:1]))
    for a, b in zip(one, got):
        torch.testing.assert_close(a[0], b[0], atol=1e-6, rtol=1e-5)


def _shared_nets():
    jcfg, tcfg = _cfgs(BBOX_ITER=2)
    jaz = japi.build_az_net(jcfg)
    tree = _np_tree(japi.build_frcnn_net(jcfg, rng=jax.random.PRNGKey(11)).params)
    tree["params"]["head"]["cls_score"]["kernel"] *= 300.0
    jfr = japi.share_trunk(japi.build_frcnn_net(jcfg, params=tree), jaz)
    taz = tapi.build_az_net(tcfg, state_dict=params_from_flax(_np_tree(jaz.params)),
                            device="cpu")
    tfr = tapi.build_frcnn_net(tcfg, state_dict=params_from_flax(tree), device="cpu")
    return (jaz, jfr), (taz, tfr), tcfg


def test_share_trunk_and_trunks_shared():
    _, (taz, tfr), tcfg = _shared_nets()
    assert not tapi.trunks_shared(taz, tfr)
    x = torch.from_numpy(np.random.RandomState(0).uniform(-50, 50, (1, 64, 64, 3))
                         .astype(np.float32))
    with torch.no_grad():
        before = tfr.model.features(x)
        assert tapi.share_trunk(tfr, taz) is tfr
        assert tapi.trunks_shared(taz, tfr) and tapi.trunks_shared(tfr, taz)
        assert not torch.equal(before, tfr.model.features(x))
        torch.testing.assert_close(tfr.model.features(x), taz.model.features(x), rtol=0, atol=0)
    for k, v in taz.params.items():
        if k.startswith("trunk."):
            assert tfr.params[k] is v
    assert "head.cls_score.weight" in tfr.params
    other = tapi.build_az_net(dataclasses.replace(
        tcfg, MODEL=dataclasses.replace(tcfg.MODEL, WIDTH=0.125)), device="cpu")
    with pytest.raises(ValueError, match="same parameter names and shapes"):
        tapi.share_trunk(other, taz)


def test_make_fused_detect_batch_padded_matches():
    (jaz, jfr), (taz, tfr), tcfg = _shared_nets()
    tapi.share_trunk(tfr, taz)
    hws = [(100, 150), (80, 120)]
    rng = np.random.RandomState(6)
    raw = np.zeros((2, 100, 160, 3), np.uint8)
    for i, (h, w) in enumerate(hws):
        raw[i, :h, :w] = rng.randint(0, 256, (h, w, 3))
    src_hw = np.asarray(hws, np.float32)
    scales = np.asarray([tapi.compute_scale(h, w, 64, 128) for h, w in hws], np.float32)
    want = jax.jit(japi.make_fused_detect_batch_padded(
        jaz.model, jfr.model, jaz.cfg, jfr.cfg, CANVAS))(
        jaz.params, jfr.params, jnp.asarray(raw), jnp.asarray(src_hw), jnp.asarray(scales))
    got = tapi.make_fused_detect_batch_padded(taz.model, tfr.model, tcfg, tcfg, CANVAS)(
        torch.from_numpy(raw), torch.from_numpy(src_hw), torch.from_numpy(scales))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].any()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-3, rtol=0)
    _assert_dets(got[3:], want[3:], "float32")
    # The fused program against the two-program path on the same boxes.
    det = tapi.make_detect_batch_padded(tfr.model, tcfg, CANVAS)(
        torch.from_numpy(raw), torch.from_numpy(src_hw), torch.from_numpy(scales), got[0])
    _assert_dets(det, got[3:], "float32")


def test_builders_run_on_the_card_by_default(monkeypatch):
    """With no card, a net built without ``device='cpu'`` raises instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs()
    for build in (tapi.build_az_net, tapi.build_frcnn_net):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(tcfg)
    assert tapi.build_frcnn_net(tcfg, device="cpu").device == torch.device("cpu")
