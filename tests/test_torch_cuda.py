"""On a card: the CUDA kernels against their plain PyTorch versions, bit for
bit (NMS keep masks; int8 conv codes and bf16 exits; the fused ROI align),
or within one bf16 ulp (the fused conv1 block, whose f32 sums run in another
order inside ``mma``). Imports no JAX, so it runs where JAX is absent:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips (the kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

from aznet_tpu_torch import api as tapi
from aznet_tpu_torch.config import Config, cfg_from_dict
from aznet_tpu_torch.models.heads import int8_matmul
from aznet_tpu_torch.models.vgg import VGG16Trunk
from aznet_tpu_torch.ops import conv1_fused as tconv1
from aznet_tpu_torch.ops import conv_int8 as tconv
from aznet_tpu_torch.ops import nms as tnms
from aznet_tpu_torch.ops import roi_pool as troi
from aznet_tpu_torch.ops.cuda import conv1_kernel, conv_int8_kernel, nms_kernel, roi_align_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, bsz, n, dev, ties=True):
    """Boxes in [0, 1500] plus wh in [5, 300]; stream 0 tie-heavy with +-0,
    subnormal and invalid rows when ``ties``."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 1500, (bsz, n, 2)).astype(np.float32)
    wh = rng.uniform(5, 300, (bsz, n, 2)).astype(np.float32)
    scores = rng.rand(bsz, n).astype(np.float32)
    valid = np.ones((bsz, n), bool)
    if ties:
        scores[0] = np.floor(scores[0] * 8) / 8
        scores[0, : n // 8] = -0.0
        scores[0, n // 8: n // 6] = np.float32(1e-40)
        scores[0, n // 6: n // 5] = np.float32(-3e-39)
        valid[0] = rng.rand(n) > 0.1
    return [torch.from_numpy(a).to(dev) for a in
            (np.concatenate([xy, xy + wh], -1), scores, valid)]


@pytest.mark.parametrize("bsz,n,thresh,offset", [
    (1, 2048, 0.7, 1.0), (4, 1000, 0.5, 1.0), (3, 64, 0.3, 0.0), (1, 1, 0.5, 1.0),
    (2, 4097, 0.5, 1.0), (1, 8192, 0.7, 1.0),
])
def test_kernel_equals_plain(dev, bsz, n, thresh, offset):
    boxes, scores, valid = _case(bsz * 7 + n, bsz, n, dev)
    before = nms_kernel.LAUNCHES
    got = tnms.nms_mask_batched(boxes, scores, thresh, valid, offset)
    assert nms_kernel.LAUNCHES == before + 1
    want = tnms.nms_mask_reference(boxes, scores, thresh, valid, offset)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_nms_topk_on_card_equals_cpu(dev):
    boxes, scores, valid = _case(3, 1, 2048, dev, ties=False)
    got = tnms.nms_topk(boxes[0], scores[0], 0.7, 300, valid=valid[0])
    want = tnms.nms_topk(boxes[0].cpu(), scores[0].cpu(), 0.7, 300, valid=valid[0].cpu())
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_kernel_rejects_oversize(dev):
    boxes, scores, valid = _case(1, 1, nms_kernel.MAX_N + 1, dev, ties=False)
    with pytest.raises(ValueError, match="N <="):
        nms_kernel.nms_cuda_batched(boxes, scores, 0.5, valid)


def _conv_case(seed, bsz, h, w, c, co, dev):
    """int8 activations in [-127, 127], a quantized random-normal layer."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(-127, 128, (bsz, h, w, c)).astype(np.int8)).to(dev)
    weight = torch.from_numpy((rng.randn(co, c, 3, 3) * 0.05).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-1, 1, co).astype(np.float32))
    layer = tconv.Int8Conv.from_float(weight.to(dev), bias.to(dev))
    return x, layer


# (B, H, W, C, Co, pool, s_out): non-power-of-two scales; VGG shapes, a C=64
# input, widths that are not multiples of 32/128, odd sizes, a bf16 exit.
CONV_CASES = [
    (2, 20, 24, 128, 128, True, 0.7131), (2, 76, 100, 256, 512, True, 0.3717),
    (2, 13, 10, 128, 128, False, 0.5519), (1, 38, 50, 512, 512, False, None),
    (1, 9, 70, 64, 128, False, 0.4441), (2, 8, 8, 16, 32, False, 0.2923),
    (2, 6, 66, 24, 40, True, 0.8317), (1, 5, 33, 8, 8, False, None),
]


@pytest.mark.parametrize("bsz,h,w,c,co,pool,s_out", CONV_CASES)
def test_conv_int8_kernel_equals_plain(dev, bsz, h, w, c, co, pool, s_out):
    x, layer = _conv_case(h * 31 + c, bsz, h, w, c, co, dev)
    s_x = 0.0419
    entry = "chain" if pool else "strip"
    before = conv_int8_kernel.LAUNCHES[entry]
    got = tconv.conv3x3_int8(x, s_x, layer, s_out, pool=pool)
    assert conv_int8_kernel.LAUNCHES[entry] == before + 1
    want = tconv.conv3x3_int8_reference(x, s_x, layer, s_out, pool=pool)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    if s_out is not None:  # the codes are not degenerate
        assert 0 < int((got != 0).sum()) < got.numel()
        assert int(got.abs().max()) > 1


def test_conv_int8_kernel_rejects(dev):
    x, layer = _conv_case(0, 1, 6, 7, 16, 16, dev)
    with pytest.raises(ValueError, match="even"):
        tconv.conv3x3_int8(x, 0.1, layer, 0.1, pool=True)
    x12, _ = _conv_case(0, 1, 6, 6, 12, 16, dev)
    with pytest.raises(ValueError, match="multiples of 8"):
        conv_int8_kernel.conv3x3_int8_strip(x12, 0.1, layer.w_k, layer.s_w, layer.bias, 0.1)


def test_int8_matmul_pads_rows(dev):
    rng = np.random.RandomState(4)
    for m in (1, 8, 17, 64):
        a = torch.from_numpy(rng.randint(-127, 128, (m, 256)).astype(np.int8))
        b = torch.from_numpy(rng.randint(-127, 128, (96, 256)).astype(np.int8))
        got = int8_matmul(a.to(dev), b.to(dev)).cpu()
        assert got.dtype == torch.int32
        assert torch.equal(got.long(), a.long() @ b.long().t())


def test_int8_trunk_body_on_card_equals_cpu(dev):
    """VGG-16 at width 0.25 (chain walk off: the strip entry and separate
    pools) and a 128-wide mini layout (fused pools): from the same int8
    codes, the card's trunk body equals the CPU's bit for bit."""
    torch.manual_seed(0)
    trunk = VGG16Trunk(width=0.25, int8_mode=True,
                       int8_scales=tuple(np.linspace(0.3, 0.05, 13)))
    trunk.prepare_int8()
    x8 = torch.randint(0, 60, (2, 34, 42, 32), dtype=torch.int8)
    want = trunk.int8_body(x8)
    gpu = trunk.to(dev)
    gpu.prepare_int8()
    before = dict(conv_int8_kernel.LAUNCHES)
    got = gpu.int8_body(x8.to(dev))
    assert conv_int8_kernel.LAUNCHES["strip"] - before["strip"] == 10
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), want)


def _roi_case(seed, h, w, c, r, dtype, dev):
    """Post-ReLU-like features; rois of every size, some past the map's
    edge, some below one cell, one all zeros (a padded frontier row)."""
    rng = np.random.RandomState(seed)
    feat = torch.from_numpy(np.maximum(rng.randn(h, w, c), 0).astype(np.float32))
    xy = rng.uniform(-40, w * 16, (r, 2))
    wh = np.exp(rng.uniform(np.log(2), np.log(900), (r, 2)))
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    rois[0] = 0.0
    return feat.to(dtype).to(dev), torch.from_numpy(rois).to(dev)


# (H, W, C, R, dtype, w_first): the slice's map (38 x 50 x 512) in both orders
# and dtypes, channel counts that are not multiples of 128, one roi.
ROI_CASES = [
    (38, 50, 512, 300, torch.bfloat16, False), (38, 50, 512, 64, torch.float32, True),
    (38, 50, 512, 64, torch.bfloat16, True), (38, 50, 512, 8, torch.float32, False),
    (13, 21, 40, 33, torch.bfloat16, False), (9, 7, 200, 1, torch.float32, True),
]


@pytest.mark.parametrize("h,w,c,r,dtype,w_first", ROI_CASES)
def test_roi_align_kernel_equals_plain(dev, h, w, c, r, dtype, w_first):
    feat, rois = _roi_case(h * 7 + r, h, w, c, r, dtype, dev)
    before = roi_align_kernel.LAUNCHES
    got = roi_align_kernel.roi_align_cuda(feat, rois, 1 / 16.0, 7, w_first)
    assert roi_align_kernel.LAUNCHES == before + 1
    want = troi.roi_align_fused_reference(feat, rois, 1 / 16.0, 7, w_first)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (r, 7, 7, c)
    assert torch.equal(got, want)
    assert float(want.float().abs().max()) > 0


def test_roi_align_dispatch_and_rejects(dev):
    feat, rois = _roi_case(1, 38, 50, 512, 8, torch.float32, dev)
    before = roi_align_kernel.LAUNCHES
    got = troi.roi_pool(feat, rois, 1 / 16.0, 7, mode="align_pallas")  # f32: W-first
    assert roi_align_kernel.LAUNCHES == before + 1
    assert torch.equal(got, troi.roi_align_fused_reference(feat, rois, 1 / 16.0, 7, True))
    with pytest.raises(TypeError, match="bf16 or f32"):
        roi_align_kernel.roi_align_cuda(feat.half(), rois, 1 / 16.0, 7, False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        roi_align_kernel.roi_align_cuda(feat, rois.cpu(), 1 / 16.0, 7, False)


# (B, H, W, C): the slice's shape cut in rows, widths that are not multiples
# of the 64-column tile, C = 16 (VGG-16 at WIDTH 0.25).
CONV1_CASES = [(2, 64, 800, 64), (1, 34, 130, 64), (2, 64, 48, 16), (1, 6, 70, 32)]


@pytest.mark.parametrize("bsz,h,w,c", CONV1_CASES)
def test_conv1_kernel_within_one_ulp(dev, bsz, h, w, c):
    rng = np.random.RandomState(h + c)
    y = torch.from_numpy(np.maximum(rng.randn(bsz, h, w, c), 0).astype(np.float32) * 40)
    w12 = torch.from_numpy((rng.randn(c, c, 3, 3) * 0.05).astype(np.float32))
    b12 = torch.from_numpy(rng.uniform(-1, 1, c).astype(np.float32))
    y, w12, b12 = (t.to(dev, torch.bfloat16) for t in (y, w12, b12))
    before = conv1_kernel.LAUNCHES
    got = conv1_kernel.conv1_2_pool_cuda(y, tconv1.kernel_weights(w12), b12.float())
    assert conv1_kernel.LAUNCHES == before + 1
    want = tconv1.conv1_2_pool_reference(y, w12, b12)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (bsz, h // 2, w // 2, c)
    ok, frac = tconv1.within_one_bf16_ulp(got, want)
    assert ok, frac
    assert 0.05 < float((want > 0).float().mean()) < 0.999


def test_conv1_kernel_rejects(dev):
    y = torch.zeros((1, 8, 8, 8), device=dev, dtype=torch.bfloat16)
    w9 = torch.zeros((9, 8, 8), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        conv1_kernel.conv1_2_pool_cuda(y, w9, torch.zeros(8, device=dev))
    with pytest.raises(TypeError, match="bf16"):
        conv1_kernel.conv1_2_pool_cuda(y.float(), w9, torch.zeros(8, device=dev))


def _detect_cfg():
    return cfg_from_dict(Config(), {
        "MODEL": {"WIDTH": 0.25, "FC_DIM": 64, "NUM_TEMPLATES": 11,
                  "POOLING_MODE": "align_pallas", "FUSE_CONV1": True},
        "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 256, "MAX_LEVELS": 3, "NUM_PROPOSALS": 50},
        "TEST": {"SCALES": (64,), "MAX_SIZE": 128, "BBOX_ITER": 2}})


def test_detect_on_card_equals_cpu(dev):
    """VGG-16 at WIDTH 0.25, bf16, align_pallas + FUSE_CONV1: im_detect on
    the card against the CPU on the same boxes; both kernels launch."""
    cfg = _detect_cfg()
    cpu_net = tapi.build_frcnn_net(cfg, device="cpu")
    gpu_net = tapi.build_frcnn_net(cfg, state_dict=cpu_net.params, device=dev)
    rng = np.random.RandomState(1)
    im = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    xy = rng.uniform(0, 80, (40, 2))
    boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(8, 60, (40, 2)), 120)], 1)
    before = (roi_align_kernel.LAUNCHES, conv1_kernel.LAUNCHES)
    got = tapi.im_detect(gpu_net, im, boxes.astype(np.float32))
    assert roi_align_kernel.LAUNCHES - before[0] == 2 and conv1_kernel.LAUNCHES - before[1] == 1
    want = tapi.im_detect(cpu_net, im, boxes.astype(np.float32))
    np.testing.assert_allclose(got[0], want[0], atol=1e-2, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=0.5, rtol=0)
