"""The detect entry's tail in one pass a call (``api._detect_heads``): the
head per image, then the softmax, the decode and the clip once over all
B x R rows. It gives the bits of the per-image form
(``_detect_tail.per_image_detect``) for one image and for several, on the
batched entry (Python clip bounds) and the padded one (``[B, 1]`` tensor
bounds), with one and two ``BBOX_ITER`` passes; and the clip with a Python
bound gives the bits of the clip with a tensor bound, on ±0, NaN, ±inf and
values past either bound.

On the card (``cuda``; skip without one): a VGG-16 detect call of 8 raw
375x500 images with 300 boxes each on the cell's 608x800 canvas, equal to
the per-image form, with ``torch.cuda.set_sync_debug_mode("error")`` on
from the trunk's return to the entry's return; the clip's two forms on the
card. Imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_detect_tail.py
"""

import numpy as np
import pytest
import torch

from _detect_tail import no_syncs_after_the_trunk, per_image_detect
from aznet_tpu_torch import api
from aznet_tpu_torch.config import Config, cfg_from_dict
from aznet_tpu_torch.ops import boxes as tboxes
from aznet_tpu_torch.ops.cuda import roi_align_kernel

torch.set_num_threads(1)

CANVAS = (64, 128)
RAW_HW = (96, 128)
R = 12
# ±0, NaN, ±inf, past the lower and the upper bound, subnormals, near the largest.
EDGES = [0.0, -0.0, float("nan"), float("inf"), float("-inf"), -5.0, -1e-40, 1e-40, 3.25,
         98.999, 99.0, 99.5, 1e9, -1e9, 3.0e38, -3.0e38]
INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float64: torch.int64}


def edge_values(dtype, device="cpu") -> torch.Tensor:
    """67 values: every edge repeated past a vector's width, so that on the
    CPU the vectorized loop and its scalar remainder both run."""
    return torch.tensor(EDGES * 4 + [7.0, -0.0, float("nan")], dtype=torch.float64).to(
        dtype).to(device)


def config(dtype: str, bbox_iter: int) -> Config:
    return cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 32, "NUM_TEMPLATES": 5, "NUM_CLASSES": 4,
                  "COMPUTE_DTYPE": dtype},
        "TEST": {"SCALES": [64], "MAX_SIZE": 128, "BBOX_ITER": bbox_iter}})


def given_boxes(b: int, r: int, hw, seed: int, device="cpu") -> torch.Tensor:
    """``[b, r, 4]`` boxes in ``hw`` images, a few reaching past its edges."""
    g = torch.Generator().manual_seed(seed)
    scale = torch.tensor([hw[1], hw[0]], dtype=torch.float32)
    xy = torch.rand(b, r, 2, generator=g) * scale * 1.1 - 0.05 * scale
    wh = 8.0 + torch.rand(b, r, 2, generator=g) * scale * 0.6
    return torch.cat([xy, xy + wh], -1).to(device)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(INT_VIEW[a.dtype]), b.view(INT_VIEW[b.dtype]))


def same_values(a: torch.Tensor, b: torch.Tensor, signed_zeros: bool = True) -> bool:
    """NaN where the other is NaN, every other element the same bits (-0 is
    not +0 unless ``signed_zeros`` is false). The CPU's vectorized
    ``torch.minimum`` returns an all-ones NaN where ``clamp`` returns its
    input's NaN, so NaN bits are not compared."""
    nan = a.isnan()
    if not signed_zeros:
        return torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])
    return torch.equal(nan, b.isnan()) and bits_equal(a[~nan], b[~nan])


@pytest.fixture(scope="module")
def nets():
    built = {}

    def get(dtype, bbox_iter):
        if (dtype, bbox_iter) not in built:
            built[dtype, bbox_iter] = api.build_frcnn_net(config(dtype, bbox_iter),
                                                          device="cpu", seed=5)
        return built[dtype, bbox_iter]
    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bbox_iter", [1, 2])
@pytest.mark.parametrize("entry", ["given", "padded"])
@pytest.mark.parametrize("b", [1, 2, 8])
def test_one_pass_tail_equals_the_per_image_tail(nets, b, entry, bbox_iter, dtype):
    net = nets(dtype, bbox_iter)
    rng = np.random.RandomState(b)
    ims = torch.from_numpy(rng.randint(0, 256, (b,) + RAW_HW + (3,)).astype(np.uint8))
    boxes = given_boxes(b, R, RAW_HW, seed=b)
    if entry == "given":
        got = api.make_detect_batch(net.model, net.cfg, CANVAS)(ims, boxes)
        want = per_image_detect(net.model, net.cfg, ims, boxes, CANVAS)
    else:  # each image its own true extent inside the padded raw shape
        hw = [(RAW_HW[0] - 7 * i, RAW_HW[1] - 11 * i) for i in range(b)]
        for i, (h, w) in enumerate(hw):
            ims[i, h:] = 0
            ims[i, :, w:] = 0
        src_hw = torch.tensor(hw, dtype=torch.float32)
        scales = torch.tensor([api.compute_scale(h, w, 64, 128) for h, w in hw])
        got = api.make_detect_batch_padded(net.model, net.cfg, CANVAS)(ims, src_hw, scales,
                                                                       boxes)
        want = per_image_detect(net.model, net.cfg, ims, boxes, CANVAS, src_hw, scales)
    assert got[0].shape == (b, R, 4) and got[1].shape == (b, R, 16)
    clipped = got[1].reshape(b, R, 4, 4)
    assert bool((clipped[..., 0] == 0).any()) and bool((clipped >= 0).all())  # the clip bites
    for g_, w_ in zip(got, want):
        assert same_values(g_, w_)


@pytest.mark.parametrize("hi", [99.0, 0.0, -3.5, float("inf")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_clip_with_a_python_bound_equals_a_tensor_bound(dtype, hi):
    """``min(max(x, 0), hi)`` on :func:`edge_values` by both forms, NaN kept
    NaN, and -0 kept by the Python bound. Where the bound is 0 (an image one
    pixel wide), the CPU's vectorized ``torch.minimum`` returns the bound's
    +0 for a -0 input and its scalar remainder -0, so there the two forms
    agree up to the sign of a zero (on the card in every bit:
    ``test_clip_bounds_agree_on_the_card``)."""
    x = edge_values(dtype)
    got = tboxes._clip(x, hi)
    want = tboxes._clip(x, torch.tensor(hi, dtype=torch.float64))
    assert same_values(got, want, signed_zeros=hi != 0) and int(got.isnan().sum()) == 5
    neg_zeros = got[(x == 0) & x.signbit()]
    assert bits_equal(neg_zeros, torch.full_like(neg_zeros, -0.0 if hi >= 0 else hi))


def test_clip_boxes_takes_one_extent_an_image():
    """``[B, 1]`` bounds clip each image's ``[R, 4K]`` boxes to its own
    extent, as one image at a time with its 0-d bounds."""
    boxes = given_boxes(3, 5, (60, 80), seed=1).repeat(1, 1, 2) * 1.5
    hw = torch.tensor([[60.0, 80.0], [40.0, 50.0], [20.0, 90.0]])
    got = tboxes.clip_boxes(boxes, (hw[:, :1], hw[:, 1:]))
    for i, (h, w) in enumerate(hw.tolist()):
        assert bits_equal(got[i], tboxes.clip_boxes(boxes[i], (hw[i, 0], hw[i, 1])))
        assert bits_equal(got[i], tboxes.clip_boxes(boxes[i], (h, w)))


# -- the card --------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_clip_bounds_agree_on_the_card(dev, dtype):
    """On the card both forms keep the input's NaN, so every bit agrees."""
    x = edge_values(dtype, dev)
    for hi in (99.0, 0.0, -3.5, float("inf")):
        got = tboxes._clip(x, hi)
        want = tboxes._clip(x, torch.tensor(hi, dtype=dtype, device=dev))
        assert bits_equal(got.cpu(), want.cpu()), hi


@pytest.mark.cuda
def test_vgg16_detect_call_of_8_on_the_card(dev, monkeypatch):
    """The VGG-16 cell's call (bf16, ROI align, fused conv1; 8 raw 375x500
    images, 300 boxes each, the 608x800 canvas): no synchronising call from
    the trunk's return to the entry's return, one ROI-align launch an image,
    and the per-image form's bits (cuDNN held to deterministic algorithms,
    since the two forms run the trunk apart)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "vgg16", "POOLING_MODE": "align_pallas", "NUM_TEMPLATES": 11,
                  "NUM_CLASSES": 21, "FC_DIM": 4096, "COMPUTE_DTYPE": "bfloat16",
                  "FUSE_CONV1": True},
        "TEST": {"SCALES": [600], "MAX_SIZE": 1000}})
    net = api.build_frcnn_net(cfg, device=dev, seed=7)
    g = torch.Generator().manual_seed(8)
    ims = torch.randint(0, 256, (8, 375, 500, 3), dtype=torch.uint8, generator=g).to(dev)
    boxes = given_boxes(8, 300, (375, 500), seed=9, device=dev)
    fn = api.make_detect_batch(net.model, cfg, (608, 800))
    fn(ims, boxes)  # builds the kernels
    torch.cuda.synchronize()
    before = roi_align_kernel.LAUNCHES
    with no_syncs_after_the_trunk(net.model):
        got = fn(ims, boxes)
    assert roi_align_kernel.LAUNCHES - before == 8
    want = per_image_detect(net.model, cfg, ims, boxes, (608, 800))
    assert got[0].shape == (8, 300, 21) and got[1].shape == (8, 300, 84)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
