"""The ResNet-101 C4 detector (``MODEL.BACKBONE = "resnet101_c4"``: ResNet-101
to conv4_x, ROI align to 14x14, conv5_x on each box, the mean over its 7x7
output, the output layers) against its plain reference,
``tests/reference_resnet101_c4.py`` (float32, TF32 off; the JAX package has
no ResNet-101), on seeded weights: every width and all 101 layers, on a
64x96 canvas with a handful of boxes.

Tolerances (features and head outputs as a share of max |x|; softmax
scores absolute; decoded boxes as the largest shift of a side over the
given box's width or height):
- Float32: 1e-4, 1e-4, 1e-5, 1e-5, as ``test_torch_resnet.py``'s: the same
  operations, the port's ROI align summing its taps in another order. Four
  weight draws read 0, at most 1.0e-6, 1.0e-7 and 5.9e-7.
- bf16: 4e-2, 1.5e-2, 5e-3, 8e-3. The port rounds every activation of its
  chain of 104 convolutions to bf16 (2^-9 relative each) where the
  reference keeps float32; the same four draws read at most 1.75e-2,
  6.0e-3, 1.6e-3 and 2.65e-3, so each tolerance is 2.3 to 3 times the
  largest reading. The widths, and so the sums' lengths, are the cell's.
  ``test_float32_tolerance_catches_bf16`` shows that the float32 tolerances
  fail the bf16 port.

Also the propose entries on the C4 AZ head, the refusals (int8,
``INT8_HEAD_SCALES``, a mesh split over ``model``; one on ``data`` alone
passes), the train step on the plain operations, and
the benchmark's copy of the network (``benchmark/reference/networks/
resnet101_c4.py``) equal to this reference on one weight dict.

On the card (``cuda``; skip without one): the ROI-align kernel at pool 14
on a 38x50x1024 bf16 map with 300 boxes against its plain version, and one
bf16 detect call of 8 images with 300 boxes each at the cell's size
(``resnet101_c4.detect_given_b8``): 163 frozen BatchNorm launches (91 for
the trunk, 9 for each image's head) and 8 ROI-align launches, its outputs
held against the reference at the bf16 tolerance and, with no synchronising
call after the trunk, against the head's tail run one image at a time, bit
for bit. Imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_resnet101_c4.py
"""

import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import reference_resnet101_c4 as ref
from _detect_tail import no_syncs_after_the_trunk, per_image_detect
from aznet_tpu_torch import api
from aznet_tpu_torch.config import Config, cfg_from_dict
from aznet_tpu_torch.kernels import KERNELS
from aznet_tpu_torch.models.aznet import AZNet
from aznet_tpu_torch.models.frcnn import FRCNN
from aznet_tpu_torch.ops import frozen_bn, roi_pool
from aznet_tpu_torch.ops.cuda import frozen_bn_kernel, roi_align_kernel
from aznet_tpu_torch.parallel.mesh import model_sharded, shard_module

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
CANVAS = (64, 96)
RAW_HW = (60, 80)
SCALE = 64
MODEL = {"BACKBONE": "resnet101_c4", "POOL_SIZE": 14, "POOLING_MODE": "align_pallas",
         "NUM_TEMPLATES": 11, "NUM_CLASSES": 21, "STEM_S2D": False}
SEAR = {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 2, "NUM_PROPOSALS": 10}
# (features, head outputs, softmax scores, box shifts), as the docstring's.
F32 = SimpleNamespace(feat=1e-4, head=1e-4, scores=1e-5, shift=1e-5)
BF16 = SimpleNamespace(feat=4e-2, head=1.5e-2, scores=5e-3, shift=8e-3)
TOLS = {"float32": F32, "bfloat16": BF16}
# The head's score layers spread their logits by 1, its box layers by 0.1.
SPREAD = {"cls_score": 1.0, "bbox_pred": 0.1, "zoom_score": 1.0, "adj_score": 1.0,
          "adj_bbox": 0.1}
HEAD_INPUT = ("head.fc.layer4_block0.conv1.weight", "head.fc.layer4_block0.downsample.weight")
# Boxes in the raw 60x80 images: whole, small, wide, tall, a corner, off-grid.
BOXES = torch.tensor([[0, 0, 79, 59], [10, 5, 25, 20], [3, 30, 77, 52], [40, 2, 52, 58],
                      [60, 40, 79, 59], [7.5, 11.25, 33.7, 41.9]], dtype=torch.float32)


def config(dtype: str = "float32", **model) -> Config:
    return cfg_from_dict(Config(), {"MODEL": {**MODEL, "COMPUTE_DTYPE": dtype, **model},
                                    "SEAR": SEAR, "TEST": {"SCALES": [SCALE], "MAX_SIZE": 128}})


def draw_params(kind: str, seed: int, device="cpu") -> dict:
    """Seeded float32 weights under the port's names: convs normal at
    1/sqrt(fan-in), frozen BatchNorm scales 1 + 0.1 N and biases 0.1 N, the
    output layers' biases 0.01 N. conv5_1's two input convs are scaled by the
    inverse of the trunk's output rms on a noise image (unit-scale pools),
    and each output layer so that its outputs spread by ``SPREAD`` over that
    image's boxes."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  (AZNet if kind == "az" else FRCNN)(config().MODEL).state_dict().items()}
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
    feat = ref.trunk(p, probe)[0]
    for name in HEAD_INPUT:
        p[name] /= float(feat.pow(2).mean().sqrt())
    out = ref.roi_forward(p, kind, feat, BOXES * SCALE / RAW_HW[0])
    for name, y in zip(ref.OUTPUTS[kind], out.values()):
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
    return {kind: draw_params(kind, seed) for kind, seed in (("frcnn", 11), ("az", 12))}


@pytest.fixture(scope="module")
def nets(params):
    """``(kind, dtype) -> Net`` on the CPU, built from the drawn weights."""
    built = {}

    def get(kind, dtype):
        if (kind, dtype) not in built:
            build = api.build_az_net if kind == "az" else api.build_frcnn_net
            built[kind, dtype] = build(config(dtype), state_dict=params[kind], device="cpu")
        return built[kind, dtype]
    return get


def blob(dtype) -> torch.Tensor:
    """The reference's preprocess of the test images, in the port's blob dtype."""
    ims = images(2, 5)
    s = ref.compute_scale(*RAW_HW, SCALE, 128)
    x = torch.stack([ref.preprocess(im, config().PIXEL_MEANS, s, *CANVAS) for im in ims])
    return x.to(torch.float32 if dtype == "float32" else torch.bfloat16)


# -- against the reference ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trunk_matches_the_reference(nets, params, dtype):
    net = nets("frcnn", dtype)
    x = blob(dtype)
    with torch.no_grad():
        got = net.model.features(x)
    want = ref.trunk(params["frcnn"], x.float())
    assert got.shape == want.shape == (2, 4, 6, 1024)
    assert rel(got, want) <= TOLS[dtype].feat


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["frcnn", "az"])
def test_roi_forward_matches_the_reference(nets, params, kind, dtype):
    """Both heads on the same features (the port's, in float32 for the
    reference): ROI align at 14, conv5_x, the pool and the output dot."""
    net = nets(kind, dtype)
    rois = BOXES * SCALE / RAW_HW[0]
    with torch.no_grad():
        feat = net.model.features(blob(dtype))[0]
        got = net.model.roi_forward(feat, rois)
    want = ref.roi_forward(params[kind], kind, feat.float(), rois)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch.float32 and got[key].shape == want[key].shape
        assert rel(got[key], want[key]) <= TOLS[dtype].head, key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_detect_entries_match_the_reference(nets, params, dtype):
    """``make_detect_batch`` on the 64x96 canvas and ``im_detect`` on its own
    canvas: softmax scores and decoded boxes."""
    net, tol = nets("frcnn", dtype), TOLS[dtype]
    ims, boxes = images(2, 5), torch.stack([BOXES, BOXES.flip(0)])
    scores, pred = api.make_detect_batch(net.model, net.cfg, CANVAS)(ims, boxes)
    want_s, want_b = ref.detect(params["frcnn"], ims, boxes, CANVAS, SCALE, 128,
                                net.cfg.PIXEL_MEANS)
    assert scores.shape == (2, 6, 21) and pred.shape == (2, 6, 84)
    assert float((scores - want_s).abs().max()) <= tol.scores
    assert shift(pred, want_b, boxes) <= tol.shift
    scores, pred = api.im_detect(net, ims[0].numpy(), BOXES.numpy())
    canvas = ref.canvas_for(*RAW_HW, SCALE, 128)
    want_s, want_b = (t[0] for t in ref.detect(params["frcnn"], ims[:1], BOXES[None], canvas,
                                               SCALE, 128, net.cfg.PIXEL_MEANS))
    assert float((torch.from_numpy(scores) - want_s).abs().max()) <= tol.scores
    assert shift(torch.from_numpy(pred), want_b, BOXES) <= tol.shift


def test_float32_tolerance_catches_bf16(nets, params):
    """The bf16 port against the float32 reference: every comparison of the
    float32 tests fails at their tolerances."""
    net = nets("frcnn", "bfloat16")
    rois = BOXES * SCALE / RAW_HW[0]
    with torch.no_grad():
        feat = net.model.features(blob("bfloat16"))
        out = net.model.roi_forward(feat[0], rois)
    assert rel(feat, ref.trunk(params["frcnn"], blob("bfloat16").float())) > F32.feat
    want = ref.roi_forward(params["frcnn"], "frcnn", feat[0].float(), rois)
    for key in want:
        assert rel(out[key], want[key]) > F32.head, key
    ims, boxes = images(2, 5), BOXES.expand(2, -1, -1)
    scores, pred = api.make_detect_batch(net.model, net.cfg, CANVAS)(ims, boxes)
    want_s, want_b = ref.detect(params["frcnn"], ims, boxes, CANVAS, SCALE, 128,
                                net.cfg.PIXEL_MEANS)
    assert float((scores - want_s).abs().max()) > F32.scores
    assert shift(pred, want_b, boxes) > F32.shift


def test_benchmarks_network_is_this_reference(params, monkeypatch):
    """``benchmark/reference/networks/resnet101_c4.py`` and this file give
    equal trunks and heads on one weight dict, so the two copies cannot
    drift; and its parameter list is the port's."""
    monkeypatch.syspath_prepend(str(BENCH))
    from reference import nets as bench_nets

    model = {**MODEL, "FEAT_STRIDE": 16}
    for kind, p in params.items():
        assert ({n: s for n, s, _ in bench_nets.param_specs(model, kind)}
                == {k: tuple(v.shape) for k, v in p.items()})
        x = blob("float32")
        feat = bench_nets.trunk(model, p, x)
        assert torch.equal(feat, ref.trunk(p, x))
        rois = BOXES * SCALE / RAW_HW[0]
        got = bench_nets.roi_forward(model, kind, p, feat[0], rois)
        want = ref.roi_forward(p, kind, feat[0], rois)
        for key in want:
            assert torch.equal(got[key], want[key]), (kind, key)


def test_the_head_records_its_span_inside_heads(nets):
    """Under a profiler each conv5_x head call is one ``heads.conv5`` span,
    ``rows`` its boxes, inside the call's one ``heads`` span (``rows`` the
    call's boxes); with no profiler nothing is recorded."""
    from torch.profiler import ProfilerActivity, profile

    from aznet_tpu_torch.utils import profiling

    net = nets("frcnn", "float32")
    fn = api.make_detect_batch(net.model, net.cfg, CANVAS)
    ims, boxes = images(2, 5), BOXES.expand(2, -1, -1)
    before = {s.id for s in profiling.spans()}
    fn(ims, boxes)
    assert {s.id for s in profiling.spans()} == before
    with profile(activities=[ProfilerActivity.CPU]):
        fn(ims, boxes)
    new = [s for s in profiling.spans() if s.id not in before]
    by_id = {s.id: s for s in new}
    conv5 = [s for s in new if s.name == "heads.conv5"]
    assert [s.attrs for s in conv5] == [{"rows": 6}] * 2
    assert [by_id[s.parent].name for s in conv5] == ["heads"] * 2
    assert [by_id[s.parent].attrs for s in conv5] == [{"rows": 12}] * 2
    assert conv5[0].parent == conv5[1].parent


# -- the propose entries on the C4 AZ head -------------------------------------

def test_propose_entries_run_through_the_c4_az_head(nets, params):
    """``make_propose_batch`` and ``im_propose`` search with the conv5_x AZ
    head and return valid proposals inside the images; the search's first
    level's head outputs equal the reference's on the port's features."""
    net = nets("az", "float32")
    ims = images(2, 6)
    calls = []
    roi_forward = net.model.roi_forward

    def logged(feat, rois, *args, **kwargs):
        out = roi_forward(feat, rois, *args, **kwargs)
        calls.append((feat, rois, out))
        return out

    net.model.roi_forward = logged
    try:
        boxes, scores, valid = api.make_propose_batch(net.model, net.cfg, CANVAS)(ims)
    finally:
        del net.model.roi_forward
    assert boxes.shape == (2, 10, 4) and bool(valid.all(-1).any())
    for b, v in zip(boxes, valid):
        kept = b[v]
        assert bool(torch.isfinite(kept).all())
        assert (kept[:, :2] >= 0).all() and (kept[:, 2] <= RAW_HW[1] - 1).all()
        assert (kept[:, 3] <= RAW_HW[0] - 1).all()
    feat, rois, got = calls[0]
    want = ref.roi_forward(params["az"], "az", feat.float(), rois)
    for key in want:
        assert rel(got[key], want[key]) <= F32.head, key
    props = api.im_propose(net, ims[0].numpy())
    assert props.ndim == 2 and props.shape[1] == 5 and 0 < props.shape[0] <= 10
    assert np.isfinite(props).all()


# -- what the conv5_x head refuses, and training -------------------------------

@pytest.mark.parametrize("override", [dict(COMPUTE_DTYPE="int8", INT8_SCALES=(0.1,) * 61),
                                      dict(INT8_HEAD_SCALES=(0.05, 0.02))],
                         ids=["int8", "int8_head_scales"])
@pytest.mark.parametrize("cls", [AZNet, FRCNN], ids=["az", "frcnn"])
def test_int8_is_refused_naming_the_backbone(cls, override):
    with pytest.raises(NotImplementedError, match="resnet101_c4.*int8"):
        with torch.device("meta"):
            cls(config("bfloat16", **override).MODEL)


def test_sharding_the_head_over_a_mesh_is_refused():
    """``shard_module`` hands the mesh to every module that takes one: on a
    mesh with two ranks on ``model`` the conv5_x head raises, naming the
    backbone."""
    with torch.device("meta"):
        model = FRCNN(config().MODEL)
    assert model.head.fc.mesh is None
    with pytest.raises(NotImplementedError, match="'resnet101_c4'.*mesh's model axis"):
        shard_module(model, SimpleNamespace(shape={"data": 1, "model": 2}))


@pytest.mark.parametrize("data", [1, 4])
def test_a_data_only_mesh_leaves_the_head_replicated(data):
    """A mesh with one rank on ``model`` (data parallelism alone, as
    ``train_az.make_train_state`` shards any mesh) passes: nothing of the
    net is split and the head's parameters stay whole."""
    with torch.device("meta"):
        model = FRCNN(config().MODEL)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    placements = shard_module(model, SimpleNamespace(shape={"data": data, "model": 1}))
    assert not [k for k, pl in placements.items() if model_sharded(pl)]
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes
    assert model.head.fc.mesh is None


def test_the_head_reads_no_fc_width():
    """``FC_DIM`` and ``FC7_DIM`` change nothing of a conv5_x head; the output
    layers take conv5_x's 2048 channels."""
    shapes = []
    for fc in ((4096, 0), (64, 32)):
        with torch.device("meta"):
            model = FRCNN(config(FC_DIM=fc[0], FC7_DIM=fc[1]).MODEL)
        shapes.append({k: tuple(v.shape) for k, v in model.state_dict().items()})
    assert shapes[0] == shapes[1]
    assert shapes[0]["head.cls_score.weight"] == (21, 2048)
    assert not [k for k in shapes[0] if ".fc6." in k or ".fc7." in k]
    assert "trunk.layer3_block22.conv3.weight" in shapes[0]


def test_train_step_runs_the_head_on_the_plain_ops(params, monkeypatch):
    """The Fast R-CNN train step on the C4 net (ROI align by the
    ``'align'`` einsums: the fused kernel is inference-only): its frozen
    BatchNorm epilogues take PyTorch's plain operations under autograd (the
    card's entry is never called), the loss is finite and conv5_x's weights
    move."""
    from aznet_tpu_torch.train.train_frcnn import make_frcnn_train_state, make_frcnn_train_step

    def refuse(*args, **kwargs):
        raise AssertionError("the card's entry was called")

    monkeypatch.setattr(frozen_bn_kernel, "frozen_bn_relu_cuda", refuse)
    state = make_frcnn_train_state(config(POOLING_MODE="align"), device="cpu",
                                   state_dict=params["frcnn"])
    step = make_frcnn_train_step(state.model)
    labels = torch.tensor([[0, 3, 7, 0]])
    inside = torch.zeros(1, 4, 84)
    for r, c in enumerate(labels[0].tolist()):
        if c:
            inside[0, r, 4 * c:4 * c + 4] = 1.0
    batch = {"images": blob("float32")[:1], "rois": BOXES[None, :4] * SCALE / RAW_HW[0],
             "roi_valid": torch.ones(1, 4, dtype=torch.bool), "labels": labels,
             "bbox_targets": 0.1 * inside, "bbox_inside": inside}
    before = state.model.head.fc.layer4_block2.conv3.weight.detach().clone()
    metrics = step(state, batch, 5)
    assert math.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert not torch.equal(state.model.head.fc.layer4_block2.conv3.weight, before)


# -- the card --------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("w_first", [None, False], ids=["order_rule", "h_first"])
def test_roi_align_kernel_at_pool_14(dev, w_first):
    """A 38x50x1024 bf16 map (the cell's canvas at stride 16) and 300 boxes
    pooled at 14 on the card, against the plain version on the card by the
    kernel table's rule (bit for bit); the order rule picks W-first here."""
    g = torch.Generator(dev).manual_seed(21)
    feat = torch.randn(38, 50, 1024, generator=g, device=dev).to(torch.bfloat16)
    xy = torch.rand(300, 2, generator=g, device=dev) * torch.tensor([700.0, 500.0], device=dev)
    wh = 16.0 + torch.rand(300, 2, generator=g, device=dev) * 300.0
    rois = torch.cat([xy, xy + wh], 1)
    wf = roi_pool.fused_w_first(38, 50, 1024, 2, 14)
    assert wf
    order = wf if w_first is None else w_first
    row = KERNELS["roi_align"]
    before = roi_align_kernel.LAUNCHES
    got = row.card(feat, rois, 1.0 / 16, 14, order)
    assert roi_align_kernel.LAUNCHES == before + 1
    want = row.plain(feat, rois, 1.0 / 16, 14, order)
    assert got.shape == (300, 14, 14, 1024)
    ok, differ = row.rule(got, want)
    assert ok, f"{differ:.3%} of the elements differ"


def card_call_of_8(dev):
    """The cell's call on the card: a bf16 net of drawn weights, 8 raw
    375x500 images with 300 boxes each, the entry on the 608x800 canvas,
    called once to build the kernels. ``(cfg, p, net, ims, boxes, fn)``."""
    p = draw_params("frcnn", 11)
    cfg = cfg_from_dict(Config(), {"MODEL": dict(MODEL, COMPUTE_DTYPE="bfloat16"),
                                   "TEST": {"SCALES": [600], "MAX_SIZE": 1000}})
    net = api.build_frcnn_net(cfg, state_dict=p, device=dev)
    ims = images(8, 7, (375, 500), dev)
    g = torch.Generator().manual_seed(8)
    xy = torch.rand(8, 300, 2, generator=g) * torch.tensor([400.0, 300.0])
    wh = 16.0 + torch.rand(8, 300, 2, generator=g) * torch.tensor([99.0, 74.0])
    boxes = torch.cat([xy, xy + wh], -1).to(dev)
    fn = api.make_detect_batch(net.model, cfg, (608, 800))
    fn(ims, boxes)  # builds the kernels
    torch.cuda.synchronize()
    return cfg, p, net, ims, boxes, fn


@pytest.mark.cuda
def test_detect_call_of_8_on_the_card(dev):
    """One bf16 detect call at the cell's size: 8 raw 375x500 images with
    300 boxes each on the 608x800 canvas. 163 frozen BatchNorm launches (the
    trunk's 91: the stem and 3 a block over 30 blocks; each image's head 9)
    and 8 ROI-align launches; the scores and boxes held against the float32
    reference on the card at the bf16 tolerance."""
    cfg, p, _, ims, boxes, fn = card_call_of_8(dev)
    launches = frozen_bn_kernel.LAUNCHES, roi_align_kernel.LAUNCHES
    scores, pred = fn(ims, boxes)
    torch.cuda.synchronize()
    assert (frozen_bn_kernel.LAUNCHES - launches[0], roi_align_kernel.LAUNCHES - launches[1]) \
        == (163, 8)
    want_s, want_b = ref.detect({k: v.to(dev) for k, v in p.items()}, ims, boxes, (608, 800),
                                600, 1000, cfg.PIXEL_MEANS)
    assert float((scores - want_s).abs().max()) <= BF16.scores
    assert shift(pred, want_b, boxes) <= BF16.shift


@pytest.mark.cuda
def test_the_detect_tail_is_one_pass_on_the_card(dev, monkeypatch):
    """The same call with ``torch.cuda.set_sync_debug_mode("error")`` on from
    the trunk's return to the entry's return raises nothing, launches 163
    frozen BatchNorm and 8 ROI-align kernels, and gives the bits of the
    per-image form (``tests/_detect_tail.py``; cuDNN held to deterministic
    algorithms, since the two forms run the trunk apart)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg, _, net, ims, boxes, fn = card_call_of_8(dev)
    launches = frozen_bn_kernel.LAUNCHES, roi_align_kernel.LAUNCHES
    with no_syncs_after_the_trunk(net.model):
        got = fn(ims, boxes)
    assert (frozen_bn_kernel.LAUNCHES - launches[0], roi_align_kernel.LAUNCHES - launches[1]) \
        == (163, 8)
    want = per_image_detect(net.model, cfg, ims, boxes, (608, 800))
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)


@pytest.mark.cuda
def test_the_card_detect_call_equals_the_plain_ops(dev, monkeypatch):
    """The same call with the frozen BatchNorm and ROI-align kernels swapped
    for their plain versions on the card gives the same bits (cuDNN held to
    deterministic algorithms)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    p = draw_params("frcnn", 13)
    cfg = cfg_from_dict(Config(), {"MODEL": dict(MODEL, COMPUTE_DTYPE="bfloat16"),
                                   "TEST": {"SCALES": [600], "MAX_SIZE": 1000}})
    net = api.build_frcnn_net(cfg, state_dict=p, device=dev)
    ims = images(2, 9, (375, 500), dev)
    boxes = torch.stack([BOXES * 5.0, BOXES.flip(0) * 5.0]).to(dev)
    fn = api.make_detect_batch(net.model, cfg, (608, 800))
    got = fn(ims, boxes)
    monkeypatch.setattr(frozen_bn_kernel, "frozen_bn_relu_cuda",
                        frozen_bn.frozen_bn_relu_reference)
    monkeypatch.setattr(roi_align_kernel, "roi_align_cuda", roi_pool.roi_align_fused_reference)
    want = fn(ims, boxes)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
