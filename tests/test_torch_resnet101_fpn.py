"""Faster R-CNN with a Feature Pyramid Network on ResNet-101
(``MODEL.BACKBONE = "resnet101_fpn"``: ResNet-101 through conv5_x over the
image, the top-down pathway to P2-P5, each box ROI-aligned to 7x7x256 from
its own level, fc6 and fc7 of 1024, 81 classes) against its plain
reference, ``tests/reference_resnet101_fpn.py`` (float32, TF32 off; the JAX
package has no FPN), on seeded weights: every width and all 101 layers, on a
128x160 canvas (levels 32x40 to 4x5) with boxes on all four levels.

Tolerances (levels, pools and head outputs as a share of max |x|; softmax
scores absolute; decoded boxes as the largest shift of a side over the
given box's width or height):
- Float32: 1e-4, 1e-4, 1e-4, 1e-5, 1e-5, as ``test_torch_resnet101_c4.py``'s:
  the same operations, the port's ROI align summing its taps in another
  order. Four weight draws read 0 (the levels equal), at most 1.9e-7,
  4.1e-7, 6.0e-8 and 3.4e-7.
- bf16: 4e-2, 2e-2, 2e-2, 4e-3, 1e-2. The port rounds every activation of
  its 112 convolutions, the pathway's sums and the pools to bf16 (2^-9
  relative each) where the reference keeps float32; the same four draws
  read at most 1.65e-2, 7.4e-3, 7.2e-3, 1.62e-3 and 4.17e-3, so each
  tolerance is 2.4 to 2.8 times the largest reading.
  ``test_float32_tolerance_catches_bf16`` shows that the float32 tolerances
  fail the bf16 port.

Also: the level of eq. 1 in its threshold form against Detectron's form on
boxes at and near every boundary; the plain pooling over levels box for box
against the single-map plain version on the box's level; the refusals
(AZ-Net's head, int8, ``INT8_HEAD_SCALES``, ``INT8_ROI``, Caffe's max
pooling, a mesh split over ``model``, the train step); single-map nets
through the changed head loop and pooling, bit for bit; ``im_detect``'s
image pyramid over the feature pyramid; the spans; and the
benchmark's copy of the network (``benchmark/reference/networks/
resnet101_fpn.py``) equal to this reference.

On the card (``cuda``; skip without one): the levels kernel bit for bit
with its plain version at the cell's shapes (1000 boxes on 200x272 to 25x34
maps, bf16 and float32), and one bf16 detect call of 4 images with 1000
boxes each at the cell's size (``resnet101_fpn.detect_coco_b4``): one
levels launch an image and none of the single-map kernel, no synchronising
call from the trunk's return to the entry's return, every levels launch
held against its plain version by the kernel table, the outputs held
against the reference at the bf16 tolerance, and bit for bit with the
kernels swapped for their plain versions; the trunk's CUDA graph bit for
bit with its layers, counting their launches; the padded batch entry and
``im_detect`` on the card against the reference. Imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_resnet101_fpn.py
"""

import dataclasses
import math
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import reference_resnet101_fpn as ref
from _detect_tail import no_syncs_after_the_trunk
from aznet_tpu_torch import api, kernels
from aznet_tpu_torch.config import Config, cfg_from_dict
from aznet_tpu_torch.models.aznet import AZNet
from aznet_tpu_torch.models.frcnn import FRCNN
from aznet_tpu_torch.ops import frozen_bn, roi_pool
from aznet_tpu_torch.ops.cuda import frozen_bn_kernel, roi_align_kernel
from aznet_tpu_torch.parallel.mesh import shard_module

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
CANVAS = (128, 160)
RAW_HW = (120, 150)
SCALE, MAX_SIZE = 128, 256
IM_SCALE = SCALE / RAW_HW[0]
MODEL = {"BACKBONE": "resnet101_fpn", "POOL_SIZE": 7, "POOLING_MODE": "align_pallas",
         "NUM_CLASSES": 81, "FC_DIM": 1024, "FC7_DIM": 0, "STEM_S2D": False}
# (levels, pools, head outputs, softmax scores, box shifts), as the docstring's.
F32 = SimpleNamespace(feat=1e-4, pool=1e-4, head=1e-4, scores=1e-5, shift=1e-5)
BF16 = SimpleNamespace(feat=4e-2, pool=2e-2, head=2e-2, scores=4e-3, shift=1e-2)
TOLS = {"float32": F32, "bfloat16": BF16}
# The head's score layer spreads its logits by 1, its box layer by 0.1.
SPREAD = {"cls_score": 1.0, "bbox_pred": 0.1}
# Boxes in the raw 120x150 images (scale 128/120): two on P2 (small,
# off-grid), the whole image on P3, two on P4 (one past the image), one on
# P5 (past the image, as a large proposal may be), wide and tall on P3.
BOXES = torch.tensor([[10, 5, 25, 20], [7.5, 11.25, 33.7, 61.9], [0, 0, 149, 119],
                      [0, 0, 299, 299], [20, 10, 249, 189], [0, 0, 449, 449],
                      [3, 30, 147, 112], [40, 2, 130, 118]], dtype=torch.float32)


def config(dtype: str = "float32", **model) -> Config:
    return cfg_from_dict(Config(), {"MODEL": {**MODEL, "COMPUTE_DTYPE": dtype, **model},
                                    "TEST": {"SCALES": [SCALE], "MAX_SIZE": MAX_SIZE}})


def draw_params(seed: int, device="cpu") -> dict:
    """Seeded float32 weights under the port's names: convs and fc layers
    normal at 1/sqrt(fan-in), frozen BatchNorm scales 1 + 0.1 N, the other
    biases 0.1 N and the output layers' 0.01 N. fc6 is scaled by the inverse
    of the pyramid's rms over every level on a noise image (unit-scale
    pools), and each output layer so that its outputs spread by ``SPREAD``
    over that image's boxes."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in FRCNN(config().MODEL).state_dict().items()}
    g = torch.Generator().manual_seed(seed)
    p = {}
    for name, shape in shapes.items():
        x = torch.randn(shape, generator=g)
        if name.endswith(".scale"):
            x = 1.0 + 0.1 * x
        elif len(shape) >= 2:
            x = x / math.sqrt(math.prod(shape[1:]))
        else:
            x = (0.01 if name.split(".")[1] in SPREAD else 0.1) * x
        p[name] = x
    probe = 255.0 * torch.rand((1,) + CANVAS + (3,), generator=g) - 128.0
    feat = tuple(level[0] for level in ref.trunk(p, probe))
    p["head.fc.fc6.weight"] /= float(torch.cat([f.flatten() for f in feat]).pow(2).mean().sqrt())
    out = ref.roi_forward(p, feat, BOXES * IM_SCALE)
    for name, y in zip(ref.OUTPUTS, out.values()):
        p[f"head.{name}.weight"] *= SPREAD[name] / float(y.std())
    return {k: v.to(device) for k, v in p.items()}


def images(n: int, seed: int, hw=RAW_HW, device="cpu") -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n,) + tuple(hw) + (3,), dtype=torch.uint8, generator=g).to(device)


def rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def shift(pred, want, boxes) -> float:
    """The largest gap of a decoded box's side (``[..., 4K]``) over the given
    box's (``[..., 4]``) width or height."""
    w = (boxes[..., 2] - boxes[..., 0] + 1.0)[..., None]
    h = (boxes[..., 3] - boxes[..., 1] + 1.0)[..., None]
    d = (pred.float() - want.float()).abs().reshape(*pred.shape[:-1], -1, 4)
    return float(torch.maximum(torch.maximum(d[..., 0], d[..., 2]) / w,
                               torch.maximum(d[..., 1], d[..., 3]) / h).max())


@pytest.fixture(scope="module")
def params():
    return draw_params(11)


@pytest.fixture(scope="module")
def nets(params):
    """``dtype -> Net`` on the CPU, built from the drawn weights."""
    built = {}

    def get(dtype):
        if dtype not in built:
            built[dtype] = api.build_frcnn_net(config(dtype), state_dict=params, device="cpu")
        return built[dtype]
    return get


def blob(dtype) -> torch.Tensor:
    """The reference's preprocess of the test images, in the port's blob dtype."""
    ims = images(2, 5)
    s = ref.compute_scale(*RAW_HW, SCALE, MAX_SIZE)
    x = torch.stack([ref.preprocess(im, config().PIXEL_MEANS, s, *CANVAS) for im in ims])
    return x.to(torch.float32 if dtype == "float32" else torch.bfloat16)


def port_levels(net, dtype) -> tuple:
    with torch.no_grad():
        return net.model.features(blob(dtype))


# -- against the reference ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pyramid_matches_the_reference(nets, params, dtype):
    got = port_levels(nets(dtype), dtype)
    want = ref.trunk(params, blob(dtype).float())
    assert [tuple(f.shape) for f in got] == [tuple(f.shape) for f in want] == [
        (2, 32, 40, 256), (2, 16, 20, 256), (2, 8, 10, 256), (2, 4, 5, 256)]
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype) and g.is_contiguous()
        assert rel(g, w) <= TOLS[dtype].feat


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_levels_pools_and_head_match_the_reference(nets, params, dtype):
    """On the port's own levels (in float32 for the reference): every box at
    the reference's level, each of the four levels used, the pools from
    those levels, and the head's outputs."""
    net = nets(dtype)
    rois = BOXES * IM_SCALE
    feat = tuple(level[1] for level in port_levels(net, dtype))
    level = roi_pool.box_levels(rois, net.model.trunk.level_strides)
    assert torch.equal(level, ref.levels(rois)) and set(level.tolist()) == {0, 1, 2, 3}
    with torch.no_grad():
        pooled = net.model.roi_pool_only(feat, rois)
        got = net.model.roi_forward(feat, rois)
    feat32 = tuple(f.float() for f in feat)
    assert pooled.shape == (8, 7, 7, 256) and pooled.dtype == feat[0].dtype
    assert rel(pooled, ref.pool(feat32, rois)) <= TOLS[dtype].pool
    want = ref.roi_forward(params, feat32, rois)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch.float32 and got[key].shape == want[key].shape
        assert rel(got[key], want[key]) <= TOLS[dtype].head, key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_detect_entries_match_the_reference(nets, params, dtype):
    """``make_detect_batch`` and ``make_detect_batch_padded`` on the 128x160
    canvas and ``im_detect`` on its own canvas: softmax scores and decoded
    boxes."""
    net, tol = nets(dtype), TOLS[dtype]
    ims, boxes = images(2, 5), torch.stack([BOXES, BOXES.flip(0)])
    want_s, want_b = ref.detect(params, ims, boxes, CANVAS, SCALE, MAX_SIZE, net.cfg.PIXEL_MEANS)
    scores, pred = api.make_detect_batch(net.model, net.cfg, CANVAS)(ims, boxes)
    assert scores.shape == (2, 8, 81) and pred.shape == (2, 8, 324)
    assert float((scores - want_s).abs().max()) <= tol.scores
    assert shift(pred, want_b, boxes) <= tol.shift
    src_hw = torch.tensor([RAW_HW] * 2, dtype=torch.float32)
    fn = api.make_detect_batch_padded(net.model, net.cfg, CANVAS)
    padded = fn(ims, src_hw, torch.full((2,), IM_SCALE), boxes)
    assert float((padded[0] - want_s).abs().max()) <= tol.scores
    assert shift(padded[1], want_b, boxes) <= tol.shift
    scores, pred = api.im_detect(net, ims[0].numpy(), BOXES.numpy())
    canvas = ref.canvas_for(*RAW_HW, SCALE, MAX_SIZE)
    want_s, want_b = (t[0] for t in ref.detect(params, ims[:1], BOXES[None], canvas, SCALE,
                                               MAX_SIZE, net.cfg.PIXEL_MEANS))
    assert float((torch.from_numpy(scores) - want_s).abs().max()) <= tol.scores
    assert shift(torch.from_numpy(pred), want_b, BOXES) <= tol.shift


def test_image_pyramid_im_detect_takes_each_boxs_scale(params):
    """``im_detect`` with two ``TEST.SCALES`` (an image pyramid over the
    feature pyramid) gives each box the outputs of the one-scale
    ``im_detect`` at the scale whose scaled area is nearest 224**2, within
    the float32 tolerances (the head runs on another set of rows)."""
    im, cfgs = images(1, 5)[0].numpy(), {}
    for scales in ((128, 96), (128,), (96,)):
        cfgs[scales] = cfg_from_dict(Config(), {"MODEL": {**MODEL, "COMPUTE_DTYPE": "float32"},
                                                "TEST": {"SCALES": list(scales),
                                                         "MAX_SIZE": MAX_SIZE}})
    net = api.build_frcnn_net(cfgs[128, 96], state_dict=params, device="cpu")
    both = api.im_detect(net, im, BOXES.numpy())
    singles = [api.im_detect(dataclasses.replace(net, cfg=cfgs[s,]), im, BOXES.numpy())
               for s in (128, 96)]
    area = (BOXES[:, 2] - BOXES[:, 0] + 1.0) * (BOXES[:, 3] - BOXES[:, 1] + 1.0)
    errs = torch.stack([(area * (s / RAW_HW[0]) ** 2 - 224.0 ** 2).abs() for s in (128, 96)])
    pick = errs.argmin(0)
    assert set(pick.tolist()) == {0, 1}
    for i, j in enumerate(pick.tolist()):
        assert abs(both[0][i] - singles[j][0][i]).max() <= F32.scores, i
        assert shift(torch.from_numpy(both[1][i:i + 1]), torch.from_numpy(singles[j][1][i:i + 1]),
                     BOXES[i:i + 1]) <= F32.shift, i


def test_float32_tolerance_catches_bf16(nets, params):
    """The bf16 port against the float32 reference: every comparison of the
    float32 tests fails at their tolerances."""
    net = nets("bfloat16")
    rois = BOXES * IM_SCALE
    levels = port_levels(net, "bfloat16")
    want = ref.trunk(params, blob("bfloat16").float())
    assert all(rel(g, w) > F32.feat for g, w in zip(levels, want))
    feat = tuple(level[0] for level in levels)
    feat32 = tuple(f.float() for f in feat)
    with torch.no_grad():
        assert rel(net.model.roi_pool_only(feat, rois), ref.pool(feat32, rois)) > F32.pool
        out = net.model.roi_forward(feat, rois)
    want = ref.roi_forward(params, feat32, rois)
    for key in want:
        assert rel(out[key], want[key]) > F32.head, key
    ims, boxes = images(2, 5), BOXES.expand(2, -1, -1)
    scores, pred = api.make_detect_batch(net.model, net.cfg, CANVAS)(ims, boxes)
    want_s, want_b = ref.detect(params, ims, boxes, CANVAS, SCALE, MAX_SIZE, net.cfg.PIXEL_MEANS)
    assert float((scores - want_s).abs().max()) > F32.scores
    assert shift(pred, want_b, boxes) > F32.shift


def test_align_mode_pools_each_box_from_its_level(nets, params):
    """``POOLING_MODE 'align'`` (the einsums on each level's boxes) against
    the reference's pools, in float32."""
    net = nets("float32")
    rois = BOXES * IM_SCALE
    feat = tuple(level[0] for level in port_levels(net, "float32"))
    got = roi_pool.roi_pool_levels(feat, rois, net.model.trunk.level_strides, 7, mode="align")
    assert rel(got, ref.pool(feat, rois)) <= F32.pool


def test_align_mode_is_differentiable_and_reads_only_each_boxs_level():
    """``'align'`` over a pyramid under autograd: each box's pool equals
    ``roi_align`` of that box alone on its level, and the gradient reaches
    exactly the levels that hold boxes."""
    g = torch.Generator().manual_seed(8)
    strides = (4, 8, 16, 32)
    levels = tuple(torch.randn(h, w, 8, generator=g, requires_grad=True)
                   for h, w in ((32, 40), (16, 20), (8, 10), (4, 5)))
    rois = torch.tensor([[2.0, 3.0, 30.0, 40.0], [1.0, 2.0, 12.0, 9.0], [0.0, 0.0, 150.0, 110.0],
                         [5.0, 5.0, 60.0, 70.0], [10.0, 0.0, 79.0, 63.0]])
    level = roi_pool.box_levels(rois, strides)
    assert set(level.tolist()) == {0, 1}
    got = roi_pool.roi_pool_levels(levels, rois, strides, 7, mode="align")
    for i, k in enumerate(level.tolist()):
        want = roi_pool.roi_align(levels[k], rois[i:i + 1], 1.0 / strides[k], 7)[0]
        assert torch.allclose(got[i], want, rtol=1e-6, atol=1e-6), i
    got.square().sum().backward()
    assert [f.grad is not None and bool(f.grad.abs().sum() > 0) for f in levels] == [
        True, True, False, False]


# -- the level rule and the plain pooling over levels --------------------------

def _square(sides) -> torch.Tensor:
    """Square boxes whose +1 sides are ``sides``, at an off-grid corner."""
    s = torch.tensor(sides, dtype=torch.float64)
    x0 = torch.full_like(s, 3.25)
    return torch.stack([x0, x0, x0 + s - 1.0, x0 + s - 1.0], 1).float()


def test_the_threshold_form_is_eq1_but_at_its_boundaries():
    """Square boxes at, and 1e-3 px to 40 px either side of, each boundary
    (sides 112, 224, 448), and a sweep of sides 1 to 1200: the port's
    levels (float32 thresholds on the +1 area) equal the reference's
    threshold form everywhere, and Detectron's eq. 1 wherever the side is
    more than 2.3e-4 px from a boundary; at a boundary eq. 1's 1e-6 puts a
    box a level up that the threshold form keeps below."""
    strides = (4, 8, 16, 32)
    offsets = [-40.0, -1.0, -0.1, -0.01, -1e-3, 0.0, 1e-3, 0.01, 0.1, 1.0, 40.0]
    sides = [b + d for b in (112.0, 224.0, 448.0) for d in offsets]
    sides += torch.linspace(1.0, 1200.0, 4001).tolist()
    rois = _square(sides)
    port = roi_pool.box_levels(rois, strides)
    assert torch.equal(port, ref.levels(rois))
    real = (rois[:, 2] - rois[:, 0] + 1.0).double()
    near = torch.stack([(real - b).abs() for b in (112.0, 224.0, 448.0)]).min(0).values <= 2.3e-4
    eq1 = ref.levels_eq1(rois)
    assert torch.equal(port[~near], eq1[~near])
    assert set(port.tolist()) == {0, 1, 2, 3}
    # Just under a boundary, by more than eq. 1's margin: the level below.
    under = _square([112.0 - 1e-3, 224.0 - 1e-3, 448.0 - 1e-3])
    assert roi_pool.box_levels(under, strides).tolist() == [0, 1, 2]
    assert roi_pool.box_levels(_square([112.0, 224.0, 448.0]), strides).tolist() == [1, 2, 3]
    # Wide and tall boxes go by their area.
    flat = torch.tensor([[0.0, 0.0, 447.0, 27.0], [0.0, 0.0, 27.0, 447.0]])  # 448 x 28
    assert roi_pool.box_levels(flat, strides).tolist() == [1, 1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_levels_pool_is_the_single_map_pool_on_each_boxs_level(dtype):
    """``roi_align_levels`` on the CPU (its plain version) gives, box by box,
    ``roi_align_fused_reference`` on the box's own level at 1/stride in that
    map's contraction order, in the boxes' order; a level with no box, and
    no box at all, pass."""
    g = torch.Generator().manual_seed(3)
    shapes = ((50, 68), (25, 34), (13, 17), (7, 9))
    levels = tuple(torch.randn(h, w, 16, generator=g).to(dtype) for h, w in shapes)
    strides = (4, 8, 16, 32)
    xy = torch.rand(40, 2, generator=g) * 250.0
    side = torch.exp(torch.rand(40, 1, generator=g) * math.log(900.0 / 8.0)) * 8.0
    aspect = torch.exp((torch.rand(40, 1, generator=g) - 0.5) * math.log(4.0))
    rois = torch.cat([xy, xy + side * torch.cat([aspect.sqrt(), 1 / aspect.sqrt()], 1)], 1)
    level = roi_pool.box_levels(rois, strides)
    assert set(level.tolist()) == {0, 1, 2, 3}
    got = roi_pool.roi_align_levels(levels, rois, strides, 7)
    assert got.shape == (40, 7, 7, 16) and got.dtype == dtype
    for i, k in enumerate(level.tolist()):
        feat = levels[k]
        wf = roi_pool.fused_w_first(*feat.shape, feat.element_size(), 7)
        want = roi_pool.roi_align_fused_reference(feat, rois[i:i + 1], 1.0 / strides[k], 7, wf)
        assert torch.equal(got[i], want[0]), i
    no_p5 = rois[level < 3]
    assert torch.equal(roi_pool.roi_align_levels(levels, no_p5, strides, 7), got[level < 3])
    assert roi_pool.roi_align_levels(levels, rois[:0], strides, 7).shape == (0, 7, 7, 16)


# -- refusals --------------------------------------------------------------------

@pytest.mark.parametrize("override,what", [
    ({}, "AZ-Net's search head"),
    (dict(COMPUTE_DTYPE="int8", INT8_SCALES=(0.1,) * 67), "int8"),
    (dict(INT8_HEAD_SCALES=(0.05, 0.02)), "int8"),
    (dict(INT8_ROI=True, POOLING_MODE="align"), "int8"),
    (dict(POOLING_MODE="caffe_max"), "POOLING_MODE 'caffe_max'"),
], ids=["az", "int8", "int8_head_scales", "int8_roi", "caffe_max"])
def test_what_the_pyramid_cannot_run_is_refused_naming_the_backbone(override, what):
    cls = AZNet if not override else FRCNN
    with pytest.raises(NotImplementedError, match=f"'resnet101_fpn'.*{what}"):
        with torch.device("meta"):
            cls(config("bfloat16", **override).MODEL)


def test_sharding_over_the_model_axis_is_refused():
    """``shard_module`` hands the mesh to every module that takes one: on a
    mesh with two ranks on ``model`` the pyramid's trunk raises, naming the
    backbone, before any parameter is split; a mesh with one rank on
    ``model`` passes."""
    with torch.device("meta"):
        model = FRCNN(config().MODEL)
    shapes = {k: v.shape for k, v in model.named_parameters()}
    with pytest.raises(NotImplementedError, match="'resnet101_fpn'.*mesh's model axis"):
        shard_module(model, SimpleNamespace(shape={"data": 1, "model": 2},
                                            coords={"data": 0, "model": 0}))
    assert {k: v.shape for k, v in model.named_parameters()} == shapes
    assert model.head.fc.mesh is None
    with torch.device("meta"):
        model = FRCNN(config().MODEL)
    shard_module(model, SimpleNamespace(shape={"data": 2, "model": 1},
                                        coords={"data": 0, "model": 0}))
    assert model.trunk.mesh is None


def test_the_train_step_refuses_the_pyramid(params):
    from aznet_tpu_torch.train.train_frcnn import make_frcnn_train_state, make_frcnn_train_step

    state = make_frcnn_train_state(config(POOLING_MODE="align"), device="cpu",
                                   state_dict=params)
    step = make_frcnn_train_step(state.model)
    labels = torch.tensor([[0, 3]])
    batch = {"images": blob("float32")[:1], "rois": BOXES[None, :2] * IM_SCALE,
             "roi_valid": torch.ones(1, 2, dtype=torch.bool), "labels": labels,
             "bbox_targets": torch.zeros(1, 2, 324), "bbox_inside": torch.zeros(1, 2, 324)}
    with pytest.raises(NotImplementedError, match="'resnet101_fpn'.*train step"):
        step(state, batch, 5)


# -- single maps, and what the changed code hands on -------------------------------

def test_single_map_nets_keep_their_bits_through_the_head_loop():
    """On a single-map net (smallnet) the detect entry equals the head run
    one image at a time by ``roi_forward`` on ``feats[i]`` and
    ``roi_pool_only`` equals ``roi_pool`` at ``1 / FEAT_STRIDE``, bit for
    bit; a list of each image's features (the form a caller may hand
    ``_detect_heads``) gives the same bits as the batch's tensor."""
    from _detect_tail import per_image_detect

    cfg = cfg_from_dict(Config(), {"MODEL": {"BACKBONE": "smallnet", "POOL_SIZE": 7,
                                             "POOLING_MODE": "align_pallas", "FC_DIM": 64,
                                             "COMPUTE_DTYPE": "float32"},
                                   "TEST": {"SCALES": [64], "MAX_SIZE": 128}})
    net = api.build_frcnn_net(cfg, device="cpu", seed=4)
    ims = images(2, 7, (60, 80))
    boxes = torch.stack([BOXES[:4] / 2, BOXES[4:] / 3])
    got = api.make_detect_batch(net.model, cfg, (64, 96))(ims, boxes)
    want = per_image_detect(net.model, cfg, ims, boxes, (64, 96))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():
        feats = net.model.features(torch.randn(2, 64, 96, 3))
        rois = boxes * (64 / 60)
        assert torch.equal(net.model.roi_pool_only(feats[0], rois[0]),
                           roi_pool.roi_pool(feats[0], rois[0], 1 / 16, 7, mode="align_pallas"))
        args = (boxes, rois, torch.full((2,), 64 / 60), (60.0, 80.0))
        by_tensor = api._detect_heads(net.model, cfg, feats, *args)
        by_list = api._detect_heads(net.model, cfg, list(feats), *args)
    assert all(torch.equal(a, b) for a, b in zip(by_tensor, by_list))


def test_each_image_is_handed_its_own_levels(nets):
    """``_detect_heads`` on a pyramid's batch levels, and on a list of each
    image's levels, pools image i from level[i] of every level."""
    net = nets("float32")
    levels = port_levels(net, "float32")
    boxes = torch.stack([BOXES, BOXES.flip(0)])
    args = (boxes, boxes * IM_SCALE, torch.full((2,), IM_SCALE), (120.0, 150.0))
    with torch.no_grad():
        by_levels = api._detect_heads(net.model, net.cfg, levels, *args)
        per_image = [tuple(level[i] for level in levels) for i in range(2)]
        by_list = api._detect_heads(net.model, net.cfg, per_image, *args)
        one = api._detect_heads(net.model, net.cfg, tuple(level[1:] for level in levels),
                                *(a[1:] if isinstance(a, torch.Tensor) else a for a in args))
    assert all(torch.equal(a, b) for a, b in zip(by_levels, by_list))
    assert all(torch.equal(a[1:], b) for a, b in zip(by_levels, one))


def test_the_pyramid_records_its_spans(nets):
    """Under a profiler a detect call records one ``trunk.fpn`` span inside
    ``trunk`` and one ``heads.pool`` span an image inside the call's
    ``heads`` span, ``rows`` its boxes; with no profiler nothing."""
    from torch.profiler import ProfilerActivity, profile

    from aznet_tpu_torch.utils import profiling

    net = nets("float32")
    fn = api.make_detect_batch(net.model, net.cfg, CANVAS)
    ims, boxes = images(2, 5), BOXES.expand(2, -1, -1)
    before = {s.id for s in profiling.spans()}
    fn(ims, boxes)
    assert {s.id for s in profiling.spans()} == before
    with profile(activities=[ProfilerActivity.CPU]):
        fn(ims, boxes)
    new = [s for s in profiling.spans() if s.id not in before]
    by_id = {s.id: s for s in new}
    pool = [s for s in new if s.name == "heads.pool"]
    assert [s.attrs for s in pool] == [{"rows": 8}] * 2
    assert [by_id[s.parent].name for s in pool] == ["heads"] * 2
    fpn = [s for s in new if s.name == "trunk.fpn"]
    assert len(fpn) == 1 and by_id[fpn[0].parent].name == "trunk"


def test_benchmarks_network_is_this_reference(params, monkeypatch):
    """``benchmark/reference/networks/resnet101_fpn.py`` and this file give
    equal levels, pools and heads on one weight dict, so the two copies
    cannot drift; its level rule is this one's and its parameter list the
    port's."""
    monkeypatch.syspath_prepend(str(BENCH))
    from reference import nets as bench_nets

    model = {**MODEL, "FEAT_STRIDE": 16}
    assert ({n: s for n, s, _ in bench_nets.param_specs(model, "frcnn")}
            == {k: tuple(v.shape) for k, v in params.items()})
    x = blob("float32")
    feats = bench_nets.trunk(model, params, x)
    want = ref.trunk(params, x)
    assert all(torch.equal(a, b) for a, b in zip(feats, want))
    feat = bench_nets.image_features(feats, 0)
    rois = BOXES * IM_SCALE
    net = bench_nets.network(model)
    assert torch.equal(net.levels_of(rois), ref.levels(rois))
    assert tuple(net.STRIDES) == ref.STRIDES
    assert torch.equal(net.pool(model, feat, rois, lambda t: t), ref.pool(feat, rois))
    got = bench_nets.roi_forward(model, "frcnn", params, feat, rois)
    want = ref.roi_forward(params, feat, rois)
    for key in want:
        assert torch.equal(got[key], want[key]), key


class FakeGraph:
    """A CUDA graph on the CPU: it keeps the captured pass's input and
    outputs and recomputes the outputs in place on ``replay``, with no
    Python call of the forward (no launch counted)."""

    capturing = None

    def __init__(self):
        self.body = None

    def replay(self):
        x, outs = self.body
        for o, n in zip(outs, graph_body(x)):
            o.copy_(n)


def graph_body(x):
    return x * 2, x + 1


FORWARD_RUNS = []  # each call of counting_forward, by its input's shape


def counting_forward(x):
    FORWARD_RUNS.append(tuple(x.shape))
    frozen_bn_kernel.LAUNCHES += 3
    out = graph_body(x)
    if FakeGraph.capturing is not None:
        FakeGraph.capturing.body = (x, out)
    return out


@pytest.fixture
def fake_cuda_graphs(monkeypatch):
    """``utils/cuda_graph.py`` on the CPU: CPU tensors replayable, and the
    streams and the capture of ``torch.cuda`` faked."""
    import contextlib

    from aznet_tpu_torch.utils import cuda_graph

    @contextlib.contextmanager
    def graph(g):
        FakeGraph.capturing = g
        try:
            yield
        finally:
            FakeGraph.capturing = None

    stream = SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(cuda_graph, "replayable",
                        lambda x: not torch.is_grad_enabled() and not cuda_graph.cuda_ops.RECORDING)
    for name, value in (("device", lambda d: contextlib.nullcontext()),
                        ("Stream", lambda: stream), ("current_stream", lambda: stream),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("CUDAGraph", FakeGraph), ("graph", graph)):
        monkeypatch.setattr(torch.cuda, name, value)
    return cuda_graph


def test_shape_graphs_capture_a_shapes_second_call_and_count_as_the_forward(fake_cuda_graphs):
    """``ShapeGraphs`` with the capture faked: a shape's first call runs the
    forward, its second runs it twice more (a warm-up pass, the capture) and
    replays, later ones only replay; every call counts the forward's
    launches once and returns its values; what a replay returns is a copy;
    at most ``MAX_SHAPES`` shapes are captured; under autograd, or a kernel
    recording, the forward runs."""
    graphs = fake_cuda_graphs.ShapeGraphs()
    assert fake_cuda_graphs.MAX_SHAPES == 4
    runs = FORWARD_RUNS
    runs.clear()
    x = torch.arange(4, dtype=torch.float32)
    with torch.inference_mode():
        outs = []
        for i in range(3):
            before = frozen_bn_kernel.LAUNCHES
            outs.append(graphs(counting_forward, x))
            assert frozen_bn_kernel.LAUNCHES - before == 3
            assert (len(runs), len(graphs.graphs)) == ((1, 0), (3, 1), (3, 1))[i]
        for out in outs:
            assert all(torch.equal(a, b) for a, b in zip(out, graph_body(x)))
        assert all(torch.equal(a, b) for a, b in zip(graphs(counting_forward, x + 7),
                                                     graph_body(x + 7)))
        assert all(torch.equal(a, b) for a, b in zip(outs[2], graph_body(x)))
        assert len(runs) == 3
        for n in (5, 5, 6, 6, 7, 7, 8, 8):
            graphs(counting_forward, torch.ones(n))
        assert sorted(k[0] for k in graphs.graphs) == [(4,), (5,), (6,), (7,)]
        del runs[:]
        graphs(counting_forward, torch.ones(8))
        with kernels.recording(["frozen_bn"]):
            graphs(counting_forward, x)
    graphs(counting_forward, x)
    assert runs == [(8,), (4,), (4,)]


def test_the_trunk_drops_its_graphs_where_its_parameters_move(fake_cuda_graphs):
    """A cast of the net (``nn.Module._apply``) gives the trunk new, empty
    graphs; on the CPU its forward is its layers."""
    cfg = cfg_from_dict(Config(), {"MODEL": MODEL})
    model = FRCNN(cfg.MODEL)
    model.trunk.graphs.graphs["kept"] = None
    model.to(torch.float64)
    assert model.trunk.graphs.graphs == {}


# -- the card --------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernels have no CPU mode)")
    return torch.device("cuda")


CELL_SHAPES = ((200, 272), (100, 136), (50, 68), (25, 34))  # P2-P5 of 800x1088


def cell_rois(n: int, seed: int, device) -> torch.Tensor:
    """``n`` boxes inside an 800x1067 scaled image, sides log-uniform from 26
    to 800 px, aspect 0.5 to 2 (the cell's traffic scaled), on all four
    levels."""
    g = torch.Generator().manual_seed(seed)
    side = torch.exp(torch.empty(n).uniform_(math.log(26.7), math.log(800.0), generator=g))
    ar = torch.exp(torch.empty(n).uniform_(math.log(0.5), math.log(2.0), generator=g))
    w, h = (side * ar.sqrt()).clamp(max=1066.0), (side / ar.sqrt()).clamp(max=799.0)
    x1 = torch.rand(n, generator=g) * (1067.0 - w)
    y1 = torch.rand(n, generator=g) * (800.0 - h)
    return torch.stack([x1, y1, x1 + w - 1.0, y1 + h - 1.0], 1).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_levels_kernel_at_the_cells_shapes(dev, dtype):
    """1000 boxes on the cell's four maps (200x272 to 25x34, 256 channels):
    the kernel against its plain version on the card by the kernel table's
    rule (bit for bit), one launch; the order rule picks W-first on P2 and
    P3 in bf16."""
    g = torch.Generator(dev).manual_seed(29)
    levels = tuple(torch.randn(h, w, 256, generator=g, device=dev).to(dtype)
                   for h, w in CELL_SHAPES)
    rois = cell_rois(1000, 30, dev)
    assert set(roi_pool.box_levels(rois, (4, 8, 16, 32)).tolist()) == {0, 1, 2, 3}
    strides = (4, 8, 16, 32)
    wf = tuple(roi_pool.fused_w_first(*f.shape, f.element_size(), 7) for f in levels)
    if dtype == torch.bfloat16:
        assert wf == (True, True, False, False)
    row = kernels.KERNELS["roi_align_levels"]
    args = (levels, rois, strides, 7, wf, roi_pool.level_min_areas(strides))
    before = roi_align_kernel.LAUNCHES_LEVELS
    got = row.card(*args)
    assert roi_align_kernel.LAUNCHES_LEVELS == before + 1
    want = row.plain(*args)
    assert got.shape == (1000, 7, 7, 256)
    ok, differ = row.rule(got, want)
    assert ok, f"{differ:.3%} of the elements differ"


def card_call_of_4(dev, seed: int = 11):
    """The cell's call on the card: a bf16 net of drawn weights, 4 raw
    480x640 images with 1000 boxes each, the entry on the 800x1088 canvas,
    called once to build the kernels. ``(cfg, p, net, ims, boxes, fn)``."""
    p = draw_params(seed)
    cfg = cfg_from_dict(Config(), {"MODEL": dict(MODEL, COMPUTE_DTYPE="bfloat16"),
                                   "TEST": {"SCALES": [800], "MAX_SIZE": 1333}})
    net = api.build_frcnn_net(cfg, state_dict=p, device=dev)
    ims = images(4, 7, (480, 640), dev)
    boxes = torch.stack([cell_rois(1000, 40 + i, dev) * (480 / 800) for i in range(4)])
    fn = api.make_detect_batch(net.model, cfg, (800, 1088))
    fn(ims, boxes)  # builds the kernels
    torch.cuda.synchronize()
    return cfg, p, net, ims, boxes, fn


@pytest.mark.cuda
def test_detect_call_of_4_on_the_card(dev):
    """One bf16 detect call at the cell's size: one levels launch an image
    and no single-map ROI-align launch, 100 frozen BatchNorm launches (the
    stem and 3 a block over 33 blocks: the trunk's alone), no synchronising
    call from the trunk's return to the entry's return; every levels launch
    held against its plain version; the scores and boxes held against the
    float32 reference on the card at the bf16 tolerance."""
    cfg, p, net, ims, boxes, fn = card_call_of_4(dev)
    counts = (roi_align_kernel.LAUNCHES_LEVELS, roi_align_kernel.LAUNCHES,
              frozen_bn_kernel.LAUNCHES)
    with kernels.recording(["roi_align_levels"]) as records, no_syncs_after_the_trunk(net.model):
        scores, pred = fn(ims, boxes)
    torch.cuda.synchronize()
    assert (roi_align_kernel.LAUNCHES_LEVELS - counts[0], roi_align_kernel.LAUNCHES - counts[1],
            frozen_bn_kernel.LAUNCHES - counts[2]) == (4, 0, 100)
    held = kernels.held(records)["roi_align_levels"]
    assert held["ok"] and held["n"] == 4, held
    want_s, want_b = ref.detect({k: v.to(dev) for k, v in p.items()}, ims, boxes, (800, 1088),
                                800, 1333, cfg.PIXEL_MEANS)
    assert float((scores - want_s).abs().max()) <= BF16.scores
    assert shift(pred, want_b, boxes) <= BF16.shift


@pytest.mark.cuda
def test_padded_and_one_image_entries_on_the_card(dev):
    """``make_detect_batch_padded`` (two raw 480x640 images zero-padded to
    512x704, their extents and scales given) and ``im_detect`` (one NumPy
    image on its own 832x1088 canvas) in bf16 on the card: the scores and
    boxes of the float32 reference on the same images at the bf16
    tolerance."""
    p = draw_params(11)
    cfg = cfg_from_dict(Config(), {"MODEL": dict(MODEL, COMPUTE_DTYPE="bfloat16"),
                                   "TEST": {"SCALES": [800], "MAX_SIZE": 1333}})
    net = api.build_frcnn_net(cfg, state_dict=p, device=dev)
    pc = {k: v.to(dev) for k, v in p.items()}
    ims = images(2, 9, (480, 640), dev)
    boxes = torch.stack([cell_rois(300, 50 + i, dev) * (480 / 800) for i in range(2)])
    padded = torch.zeros(2, 512, 704, 3, dtype=torch.uint8, device=dev)
    padded[:, :480, :640] = ims
    src_hw = torch.tensor([[480.0, 640.0]] * 2, device=dev)
    fn = api.make_detect_batch_padded(net.model, cfg, (800, 1088))
    scores, pred = fn(padded, src_hw, torch.full((2,), 800 / 480, device=dev), boxes)
    want_s, want_b = ref.detect(pc, ims, boxes, (800, 1088), 800, 1333, cfg.PIXEL_MEANS)
    assert float((scores - want_s).abs().max()) <= BF16.scores
    assert shift(pred, want_b, boxes) <= BF16.shift
    canvas = ref.canvas_for(480, 640, 800, 1333)
    assert canvas == (832, 1088)
    scores, pred = api.im_detect(net, ims[0].cpu().numpy(), boxes[0].cpu().numpy())
    want_s, want_b = (t[0] for t in ref.detect(pc, ims[:1], boxes[:1], canvas, 800, 1333,
                                               cfg.PIXEL_MEANS))
    assert float((torch.from_numpy(scores).to(dev) - want_s).abs().max()) <= BF16.scores
    assert shift(torch.from_numpy(pred).to(dev), want_b, boxes[0]) <= BF16.shift


@pytest.mark.cuda
def test_the_card_detect_call_equals_the_plain_ops(dev, monkeypatch):
    """The same call with the frozen BatchNorm and levels kernels swapped for
    their plain versions on the card gives the same bits (cuDNN held to
    deterministic algorithms). Each side's second call, which captures its
    trunk's CUDA graph: a graph replays the kernels it captured, so the
    plain side is a net built after the swap."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    ims, boxes, fn = card_call_of_4(dev, seed=13)[3:]
    got = fn(ims, boxes)
    monkeypatch.setattr(frozen_bn_kernel, "frozen_bn_relu_cuda",
                        frozen_bn.frozen_bn_relu_reference)
    monkeypatch.setattr(roi_align_kernel, "roi_align_levels_cuda",
                        roi_pool.roi_align_levels_reference)
    want = card_call_of_4(dev, seed=13)[-1](ims, boxes)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)


@pytest.mark.cuda
def test_the_trunks_graph_gives_its_layers_bits(dev):
    """The bf16 trunk on 4 canvases of 800x1088: its first call runs as it
    is, its second captures a CUDA graph, its third replays it; each gives
    the bits of its layers called directly and counts 100 frozen BatchNorm
    launches; a replay on other images leaves what an earlier call returned
    as it was; under a kernel recording the trunk runs as it is, through
    the wrappers."""
    cfg = cfg_from_dict(Config(), {"MODEL": dict(MODEL, COMPUTE_DTYPE="bfloat16")})
    trunk = api.build_frcnn_net(cfg, state_dict=draw_params(17), device=dev).model.trunk
    g = torch.Generator(dev).manual_seed(17)
    x, x2 = (torch.randn(4, 800, 1088, 3, generator=g, device=dev).to(torch.bfloat16)
             for _ in range(2))
    with torch.inference_mode():
        want = trunk.layers(x)
        outs = []
        for i in range(3):
            before = frozen_bn_kernel.LAUNCHES
            outs.append(trunk(x))
            assert frozen_bn_kernel.LAUNCHES - before == 100, i
            assert len(trunk.graphs.graphs) == (i > 0), i
        for out in outs:
            assert all(torch.equal(a, b) for a, b in zip(out, want))
        assert all(torch.equal(a, b) for a, b in zip(trunk(x2), trunk.layers(x2)))
        assert all(torch.equal(a, b) for a, b in zip(outs[2], want))
        with kernels.recording(["frozen_bn"], first_only=True) as records:
            assert all(torch.equal(a, b) for a, b in zip(trunk(x), want))
        assert len(records) == 1
