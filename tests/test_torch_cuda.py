"""On a card: the CUDA kernels against their plain PyTorch versions, bit for
bit (NMS keep masks; int8 conv codes and bf16 exits; the fused ROI align),
within one bf16 ulp (the bf16 fused conv1 block, whose f32 sums run in
another order inside ``wgmma``), or within twice the plain version's error
against float64 (the float32 fused conv1 block). Imports no JAX, so it runs where JAX is absent:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips (the kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

from aznet_tpu_torch import api as tapi
from aznet_tpu_torch.config import Config, cfg_from_dict
from aznet_tpu_torch.models import resnet
from aznet_tpu_torch.models.heads import int8_matmul
from aznet_tpu_torch.models.vgg import VGG16Trunk
from aznet_tpu_torch.ops import conv1_fused as tconv1
from aznet_tpu_torch.ops import conv_int8 as tconv
from aznet_tpu_torch.ops import nms as tnms
from aznet_tpu_torch.ops import roi_pool as troi
from aznet_tpu_torch.ops.cuda import (conv1_kernel, conv_int8_kernel, iou_kernel, launch_counts,
                                      nms_kernel, roi_align_kernel)
from aznet_tpu_torch.ops.iou import bbox_overlaps
from aznet_tpu_torch.utils.precision import float32_precision

pytestmark = pytest.mark.cuda


def iou_inputs(seed, n, k):
    """Boxes in [0, 1000] plus wh in [0, 200]; about one box in 16 of each
    side degenerate (wh -1, -0.5 or -30: zero, small or negative area with
    offset 1). Row 0 has a negative area, so its union with every column is
    < 0; row 1 and column 0 have zero area, so their union is 0."""
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


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")  # PyTorch's default precision flags, as chip_smoke.py runs


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
    (2, 4097, 0.5, 1.0), (1, 8192, 0.7, 1.0), (1, 4096, 0.5, 1.0), (16, 4096, 0.5, 1.0),
    # the large route (n_pad 16384 .. 32768)
    (1, 8193, 0.5, 1.0), (1, 16384, 0.7, 1.0), (2, 20000, 0.5, 1.0), (1, 32768, 0.5, 0.0),
])
def test_kernel_equals_plain(dev, bsz, n, thresh, offset):
    boxes, scores, valid = _case(bsz * 7 + n, bsz, n, dev)
    before = nms_kernel.LAUNCHES
    got = tnms.nms_mask_batched(boxes, scores, thresh, valid, offset)
    assert nms_kernel.LAUNCHES == before + 1
    want = tnms.nms_mask_reference(boxes, scores, thresh, valid, offset)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [300, 2048, 4096])
def test_kernel_keeps_all_or_one(dev, n):
    """Two ends of the scan: boxes on a grid that never overlap (every valid
    box kept), and boxes that all overlap the best one more than the
    threshold (only it kept), each in shuffled score order."""
    rng = np.random.RandomState(n)
    side = int(np.ceil(np.sqrt(n)))
    xy = np.stack([np.arange(n) % side, np.arange(n) // side], 1) * 20.0
    apart = np.concatenate([xy, xy + 10.0], 1).astype(np.float32)
    jitter = rng.uniform(0, 2, (n, 4)).astype(np.float32)
    piled = (np.array([100.0, 100.0, 400.0, 300.0], np.float32) + jitter).astype(np.float32)
    scores = torch.from_numpy(rng.permutation(n).astype(np.float32) / n).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    for boxes, want_kept in ((apart, n), (piled, 1)):
        b = torch.from_numpy(boxes).to(dev)
        got = tnms.nms_mask_batched(b[None], scores[None], 0.5, valid[None])
        want = tnms.nms_mask_reference(b[None], scores[None], 0.5, valid[None])
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert int(got.sum()) == want_kept
        if want_kept == 1:
            assert bool(got[0, int(scores.argmax())])


def test_nms_topk_on_card_equals_cpu(dev):
    boxes, scores, valid = _case(3, 1, 2048, dev, ties=False)
    got = tnms.nms_topk(boxes[0], scores[0], 0.7, 300, valid=valid[0])
    want = tnms.nms_topk(boxes[0].cpu(), scores[0].cpu(), 0.7, 300, valid=valid[0].cpu())
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_kernel_65536_equals_host_greedy(dev):
    """The largest sort width, 1 x 65536, where the plain version's float
    IoU matrices (17 GB each) do not fit: held against the host library's
    greedy NMS on distinct scores (its tie order is not the folded key's)."""
    n = nms_kernel.MAX_N
    rng = np.random.RandomState(n)
    xy = rng.uniform(0, 4000, (n, 2))
    wh = rng.uniform(5, 300, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.permutation(n).astype(np.float32) / n
    got = tnms.nms_mask_batched(torch.from_numpy(boxes)[None].to(dev),
                                torch.from_numpy(scores)[None].to(dev), 0.5)
    want = np.zeros(n, bool)
    want[tnms.nms(np.concatenate([boxes, scores[:, None]], 1), 0.5)] = True
    np.testing.assert_array_equal(got[0].cpu().numpy(), want)
    assert 0 < want.sum() < n


def test_kernel_rejects_oversize(dev):
    boxes, scores, valid = _case(1, 1, nms_kernel.MAX_N + 1, dev, ties=False)
    with pytest.raises(ValueError, match="N <="):
        nms_kernel.nms_cuda_batched(boxes, scores, 0.5, valid)


def test_wrappers_raise_where_jax_answers(dev):
    """ROADMAP.md Queue C: the card's limits that the JAX package does not
    have (``tests/test_torch_limits.py`` shows it answering): the fused
    conv1 kernels above 64 channels, the float32 one at C not a multiple of
    8, the ROI-align kernel above 16 bins (the int8 conv's multiple-of-8
    rule: ``test_conv_int8_kernel_rejects``)."""
    x = torch.zeros((1, 8, 6, 3), device=dev)
    for c, dtype, match in ((96, torch.bfloat16, "at most 64 channels"),
                            (20, torch.float32, "multiple of 8")):
        w11, w12 = torch.zeros((c, 3, 3, 3), device=dev), torch.zeros((c, c, 3, 3), device=dev)
        b = torch.zeros(c, device=dev)
        with pytest.raises(ValueError, match=match):
            tconv1.fused_conv1_pool(x.to(dtype), w11.to(dtype), b, w12.to(dtype), b)
    feat = torch.zeros((12, 14, 8), device=dev)
    rois = torch.tensor([[0.0, 0.0, 90.0, 90.0]], device=dev)
    with pytest.raises(ValueError, match="pool_size"):
        roi_align_kernel.roi_align_cuda(feat, rois, 1 / 16.0, 17, False)


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
# Then the tiles of R rows (4, or 2 on small maps) x 64 columns x 128
# channels cut raggedly: W not a multiple of 64, odd H on the strip entry,
# Co = 192 and 640, C = 8 (Cp padded to 32, 8-byte copies), b = 3, the bf16
# exit at conv5's 38x50x512 (b=2: R=4; b=1 above: R=2), and conv2_2 of the
# main path (b=2, 304x400x128 -> 128, pool) end to end; then conv1_2 and
# conv2_1 of the int8 trunk from conv1_2 (C=64: chain 608x800 -> 64, pool;
# strip 304x400 -> 128).
CONV_CASES = [
    (2, 20, 24, 128, 128, True, 0.7131), (2, 76, 100, 256, 512, True, 0.3717),
    (2, 13, 10, 128, 128, False, 0.5519), (1, 38, 50, 512, 512, False, None),
    (1, 9, 70, 64, 128, False, 0.4441), (2, 8, 8, 16, 32, False, 0.2923),
    (2, 6, 66, 24, 40, True, 0.8317), (1, 5, 33, 8, 8, False, None),
    (2, 20, 100, 128, 128, True, 0.6173), (1, 11, 70, 64, 128, False, 0.5011),
    (1, 10, 66, 128, 192, True, 0.4229), (1, 7, 33, 256, 640, False, 0.3391),
    (3, 14, 50, 512, 512, True, 0.2857), (2, 38, 50, 512, 512, False, None),
    (2, 12, 130, 8, 64, True, 0.9137), (2, 304, 400, 128, 128, True, 0.3717),
    (2, 608, 800, 64, 64, True, 0.5311), (2, 304, 400, 64, 128, False, 0.4127),
]


@pytest.mark.parametrize("bsz,h,w,c,co,pool,s_out", CONV_CASES)
def test_conv_int8_kernel_equals_plain(dev, bsz, h, w, c, co, pool, s_out):
    x, layer = _conv_case(h * 31 + c, bsz, h, w, c, co, dev)
    s_x = 0.0419
    entry = "chain" if pool else "strip"
    before = launch_counts()[entry]
    got = tconv.conv3x3_int8(x, s_x, layer, s_out, pool=pool)
    assert launch_counts()[entry] == before + 1
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
    x_many = torch.zeros((conv_int8_kernel.GRID_MAX_YZ + 1, 1, 1, 16), dtype=torch.int8,
                         device=dev)
    with pytest.raises(ValueError, match="grid too large"):
        conv_int8_kernel.conv3x3_int8_strip(x_many, 0.1, layer.w_k, layer.s_w, layer.bias, 0.1)


def test_int8_dx_conv_on_card_equals_cpu(dev):
    """The dx-packed conv (``INT8_BACKEND='xla'``) on the card equals the same
    code on the CPU bit for bit: exact int32 GEMMs, the same two f32
    roundings of the epilogue and a true division; int8 codes and bf16 exit,
    and a map of fewer than 17 rows (``int8_matmul`` pads them)."""
    for k, (bsz, h, w, c, co, s_out) in enumerate([
            (2, 13, 17, 64, 128, 0.4441), (1, 38, 50, 512, 512, None),
            (2, 2, 3, 16, 32, 0.2923), (2, 76, 100, 256, 512, 0.3717)]):
        rng = np.random.RandomState(k)
        x = torch.from_numpy(rng.randint(0, 100, (bsz, h, w, c)).astype(np.int8))
        w_q, s_w = tconv.quantize_weights(
            torch.from_numpy((rng.randn(co, c, 3, 3) * 0.05).astype(np.float32)))
        bias = torch.from_numpy(rng.uniform(-1, 1, co).astype(np.float32))
        want = tconv.conv3x3_int8_dx(x, 0.0419, w_q, s_w, bias, s_out)
        got = tconv.conv3x3_int8_dx(x.to(dev), 0.0419, w_q.to(dev), s_w.to(dev), bias.to(dev),
                                    s_out)
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want), (bsz, h, w, c, co)
        if s_out is not None:
            assert 0 < int((want != 0).sum()) < want.numel()


@pytest.mark.parametrize("backend,chain_from,width,hw", [
    ("xla", "conv2_2", 0.25, (34, 42)), ("pallas", "conv1_2", 1.0, (64, 80))])
def test_int8_trunk_on_card_equals_cpu(dev, backend, chain_from, width, hw):
    """Two int8 walks from the same int8 codes: ``'xla'`` (``_int_mm``, no
    kernel launch) and the trunk from conv1_2 at full width (conv1_2
    through the chain entry at C=64, conv2_1 through the strip entry: chain
    4, strip 8), card against CPU bit for bit."""
    torch.manual_seed(0)
    trunk = VGG16Trunk(width=width, int8_mode=True, int8_backend=backend,
                       int8_chain_from=chain_from, int8_scales=tuple(np.linspace(0.3, 0.05, 13)))
    trunk.prepare_int8()
    c = getattr(trunk, trunk.int8_bf16_prefix[-1]).out_channels
    scale = 1 if chain_from == "conv1_2" else 2
    x8 = torch.randint(0, 60, (2, hw[0] // scale, hw[1] // scale, c), dtype=torch.int8)
    want = trunk.int8_body(x8)
    gpu = trunk.to(dev)
    gpu.prepare_int8()
    before = launch_counts()
    got = gpu.int8_body(x8.to(dev))
    launched = {e: launch_counts()[e] - before[e] for e in ("chain", "strip")}
    assert launched == ({"chain": 0, "strip": 0} if backend == "xla"
                        else {"chain": 4, "strip": 8}), launched
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), want)


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
    before = launch_counts()["strip"]
    got = gpu.int8_body(x8.to(dev))
    assert launch_counts()["strip"] - before == 10
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


# (H, W, C, R, dtype, w_first, P, rois): P=6 (CaffeNet, VGG_CNN_M_1024);
# ResNet-50's 68x120x1024 map W-first at R=128; C=36, not a multiple of 8
# (element-wise loads and stores), both dtypes; rois partly off the map; one
# roi that is the whole map; a 16-byte-misaligned map (element-wise path at
# C=512); P=16 (the tap tables' limit).
ROI_EDGE_CASES = [
    (38, 50, 512, 64, torch.bfloat16, False, 6, "random"),
    (38, 50, 512, 64, torch.float32, True, 6, "random"),
    (68, 120, 1024, 128, torch.bfloat16, True, 7, "random"),
    (21, 26, 36, 40, torch.bfloat16, False, 7, "random"),
    (21, 26, 36, 40, torch.float32, True, 7, "random"),
    (38, 50, 512, 50, torch.bfloat16, False, 7, "off_map"),
    (38, 50, 512, 1, torch.bfloat16, False, 7, "whole_map"),
    (38, 50, 512, 1, torch.float32, True, 7, "whole_map"),
    (13, 21, 512, 20, torch.bfloat16, True, 7, "misaligned"),
    (30, 30, 64, 12, torch.bfloat16, False, 16, "random"),
]


@pytest.mark.parametrize("h,w,c,r,dtype,w_first,pool,kind", ROI_EDGE_CASES)
def test_roi_align_kernel_edge_cases(dev, h, w, c, r, dtype, w_first, pool, kind):
    feat, rois = _roi_case(h * 5 + c + r, h, w, c, r, dtype, dev)
    if kind == "off_map":  # every roi reaches past an edge of the map
        rng = np.random.RandomState(r)
        x1 = rng.uniform(-400, w * 16 + 200, r)
        y1 = rng.uniform(-400, h * 16 + 200, r)
        rois = torch.from_numpy(np.stack([x1, y1, x1 + rng.uniform(300, 900, r),
                                          y1 + rng.uniform(300, 900, r)], 1)
                                .astype(np.float32)).to(dev)
    elif kind == "whole_map":
        rois = torch.tensor([[0.0, 0.0, w * 16.0 - 1, h * 16.0 - 1]], device=dev)
    elif kind == "misaligned":  # contiguous, but 2 bytes off 16
        flat = torch.empty(feat.numel() + 1, dtype=dtype, device=dev)
        flat[1:] = feat.reshape(-1)
        feat = flat[1:].view(h, w, c)
        assert feat.data_ptr() % 16
    before = roi_align_kernel.LAUNCHES
    got = roi_align_kernel.roi_align_cuda(feat, rois, 1 / 16.0, pool, w_first)
    assert roi_align_kernel.LAUNCHES == before + 1
    want = troi.roi_align_fused_reference(feat, rois, 1 / 16.0, pool, w_first)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (r, pool, pool, c)
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
# of the 128-column tile (48 narrower than one), odd row-pair counts, C = 16
# (VGG-16 at WIDTH 0.25); then b=3 at 2x800 (21 tiles on an 11-block grid:
# not a multiple of it), the main path's b=2 608x800 canvas (4,256 tiles on
# the card's SMs), and C = 8 and 24 (a 16-channel chunk half past C).
CONV1_CASES = [(2, 64, 800, 64), (1, 34, 130, 64), (2, 64, 48, 16), (1, 6, 70, 32),
               (3, 2, 800, 64), (2, 608, 800, 64), (1, 6, 70, 8), (2, 34, 130, 24)]


@pytest.mark.parametrize("bsz,h,w,c", CONV1_CASES)
def test_conv1_kernel_within_one_ulp(dev, bsz, h, w, c):
    rng = np.random.RandomState(h + c)
    y = torch.from_numpy(np.maximum(rng.randn(bsz, h, w, c), 0).astype(np.float32) * 40)
    w12 = torch.from_numpy((rng.randn(c, c, 3, 3) * 0.05).astype(np.float32))
    b12 = torch.from_numpy(rng.uniform(-1, 1, c).astype(np.float32))
    y, w12, b12 = (t.to(dev, torch.bfloat16) for t in (y, w12, b12))
    before = conv1_kernel.LAUNCHES
    got = conv1_kernel.conv1_2_pool_cuda(y, tconv1.kernel_layout(w12), b12.float())
    assert conv1_kernel.LAUNCHES == before + 1
    want = tconv1.conv1_2_pool_reference(y, w12, b12)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (bsz, h // 2, w // 2, c)
    ok, frac = tconv1.within_one_bf16_ulp(got, want)
    assert ok, frac
    assert 0.05 < float((want > 0).float().mean()) < 0.999


@pytest.mark.parametrize("bsz,h,w,c", CONV1_CASES)
def test_conv1_f32_kernel_within_float64_bound(dev, bsz, h, w, c):
    """The float32 kernel against a float64 product of the same operands: at
    most twice the plain version's largest error, and within 1e-5 of the
    plain version's largest value (``ops/conv1_fused.py::float64_errors``);
    the dispatch takes it for a float32 input on the card."""
    rng = np.random.RandomState(h + c + 1)
    y = torch.from_numpy(np.maximum(rng.randn(bsz, h, w, c), 0).astype(np.float32) * 40).to(dev)
    w11 = torch.from_numpy((rng.randn(c, 3, 3, 3) * 0.05).astype(np.float32)).to(dev)
    w12 = torch.from_numpy((rng.randn(c, c, 3, 3) * 0.05).astype(np.float32)).to(dev)
    b12 = torch.from_numpy(rng.uniform(-1, 1, c).astype(np.float32)).to(dev)
    before = conv1_kernel.LAUNCHES_F32
    got = conv1_kernel.conv1_2_pool_cuda_f32(y, tconv1.kernel_layout_f32(w12), b12)
    assert conv1_kernel.LAUNCHES_F32 == before + 1
    assert got.dtype == torch.float32 and got.shape == (bsz, h // 2, w // 2, c)
    ok, errs = tconv1.float64_errors(got, y, w12, b12)
    assert ok, errs
    assert errs["plain"] > 0
    x = y[..., :3].contiguous()
    with float32_precision():
        fused = tconv1.fused_conv1_pool(x, w11, b12, w12, b12)
        assert conv1_kernel.LAUNCHES_F32 == before + 2
        y1 = tconv1.conv1_1_relu(x, w11, b12)
    assert tconv1.float64_errors(fused, y1, w12, b12)[0]


def test_conv1_kernel_rejects(dev):
    """What the kernels cannot take raises; nothing falls back. The float32
    entry takes float32 (and only float32 y and weights)."""
    y = torch.zeros((1, 8, 8, 16), device=dev, dtype=torch.bfloat16)
    w_k = tconv1.kernel_layout(torch.zeros((16, 16, 3, 3), device=dev))
    bias = torch.zeros(16, device=dev)
    with pytest.raises(ValueError, match="multiple of 8 up to 64"):
        conv1_kernel.conv1_2_pool_cuda(torch.zeros((1, 8, 8, 12), device=dev,
                                                   dtype=torch.bfloat16), w_k, bias)
    with pytest.raises(ValueError, match="multiple of 8 up to 64"):
        conv1_kernel.conv1_2_pool_cuda(y, w_k, torch.zeros(72, device=dev))
    with pytest.raises(ValueError, match="tiled layout"):
        conv1_kernel.conv1_2_pool_cuda(y, w_k[:, :8].contiguous(), bias)
    with pytest.raises(ValueError, match="even"):
        conv1_kernel.conv1_2_pool_cuda(y[:, :7].contiguous(), w_k, bias)
    with pytest.raises(TypeError, match="bf16"):
        conv1_kernel.conv1_2_pool_cuda(y.float(), w_k, bias)
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv1_kernel.conv1_2_pool_cuda(y, w_k.cpu(), bias)
    with pytest.raises(ValueError, match="at most 64"):
        tconv1.kernel_layout(torch.zeros((128, 64, 3, 3), device=dev))
    w32 = tconv1.kernel_layout_f32(torch.zeros((16, 16, 3, 3), device=dev))
    got = conv1_kernel.conv1_2_pool_cuda_f32(y.float(), w32, bias)
    assert got.dtype == torch.float32 and got.shape == (1, 4, 4, 16)
    with pytest.raises(TypeError, match="float32"):
        conv1_kernel.conv1_2_pool_cuda_f32(y.float(), w_k, bias)
    with pytest.raises(TypeError, match="float32"):
        conv1_kernel.conv1_2_pool_cuda_f32(y, w32, bias)
    with pytest.raises(TypeError, match="bf16"):
        conv1_kernel.conv1_2_pool_cuda(y, w32, bias)
    with pytest.raises(ValueError, match="tiled layout"):
        conv1_kernel.conv1_2_pool_cuda_f32(y.float(), w32[:, :1].contiguous(), bias)


@pytest.mark.parametrize("bsz", [1, 3])
@pytest.mark.parametrize("co", [8, 64])
@pytest.mark.parametrize("c", [8, 16, 64])
def test_conv1_f32_kernel_narrow_shapes(dev, c, co, bsz):
    """The float32 kernel at every C and Co its layout takes in turn (one
    16-channel stage half past C at C = 8; Co = 8 leaves 56 of the 64 wgmma
    rows zero), H = 2 (both halo rows outside the image) and W = 70 (a
    64-column tile and a ragged one of 6), against ``float64_errors``."""
    rng = np.random.RandomState(c + co + bsz)
    y = torch.from_numpy(np.maximum(rng.randn(bsz, 2, 70, c), 0).astype(np.float32) * 40)
    w12 = torch.from_numpy((rng.randn(co, c, 3, 3) * 0.05).astype(np.float32))
    b12 = torch.from_numpy(rng.uniform(-1, 1, co).astype(np.float32))
    y, w12, b12 = y.to(dev), w12.to(dev), b12.to(dev)
    before = conv1_kernel.LAUNCHES_F32
    got = conv1_kernel.conv1_2_pool_cuda_f32(y, tconv1.kernel_layout_f32(w12), b12)
    assert conv1_kernel.LAUNCHES_F32 == before + 1
    assert got.shape == (bsz, 1, 35, co)
    ok, errs = tconv1.float64_errors(got, y, w12, b12)
    assert ok, errs


def test_conv1_f32_accumulator_truncates(dev):
    """The assumption under the float32 kernel's promotion plan and its
    correction: the tensor cores' f32 accumulator truncates. One k8 step
    of the centre tap (dx = 1, no correction) sums 1 + f ulp(1) exactly in
    its hi.hi product; truncation returns 1 for every f < 1, where rounding
    to nearest would give 1 + ulp for f = 0.75."""
    w12 = torch.zeros((8, 8, 3, 3), device=dev)
    w12[:, :2, 1, 1] = 1.0
    for f in (0.25, 0.5, 0.75):
        y = torch.zeros((1, 2, 2, 8), device=dev)
        y[0, 0, 0, 0], y[0, 0, 0, 1] = 1.0, f * 2.0 ** -23
        out = conv1_kernel.conv1_2_pool_cuda_f32(y, tconv1.kernel_layout_f32(w12),
                                                 torch.zeros(8, device=dev))
        assert out[0, 0, 0].tolist() == [1.0] * 8, (f, out[0, 0, 0].tolist())


def test_conv1_f32_kernel_rejects(dev):
    """C past 64, an odd H and a non-contiguous y raise before any launch."""
    w16 = tconv1.kernel_layout_f32(torch.zeros((16, 16, 3, 3), device=dev))
    bias = torch.zeros(16, device=dev)
    before = conv1_kernel.LAUNCHES_F32
    w72 = torch.zeros((9, 9, 128, 4), device=dev)
    with pytest.raises(ValueError, match="multiple of 8 up to 64"):
        conv1_kernel.conv1_2_pool_cuda_f32(torch.zeros((1, 8, 8, 72), device=dev), w72, bias)
    with pytest.raises(ValueError, match="even"):
        conv1_kernel.conv1_2_pool_cuda_f32(torch.zeros((1, 7, 8, 16), device=dev), w16, bias)
    y = torch.zeros((1, 8, 16, 16), device=dev)[:, :, ::2]
    assert not y.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        conv1_kernel.conv1_2_pool_cuda_f32(y, w16, bias)
    assert conv1_kernel.LAUNCHES_F32 == before


def test_sample_grid_on_card_is_the_cpus(dev):
    """The ``'align'`` ROI align's sample grid: computed on the card as it
    was (``(arange + 0.5) / n`` on a CUDA tensor), PyTorch multiplies by the
    float32 reciprocal and differs from the true division at n = 12 and 14
    (P = 6 and 7, two samples); ``sample_grid`` builds it on the host and
    equals the CPU's bit for bit."""
    for n in (12, 14):
        i = np.arange(n, dtype=np.float32) + np.float32(0.5)
        old = ((torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n).cpu().numpy()
        np.testing.assert_array_equal(old, i * (np.float32(1) / np.float32(n)))
        assert (old != i / np.float32(n)).any()
        new = troi.sample_grid(n, dev)
        assert new.is_cuda
        assert torch.equal(new.cpu(), troi.sample_grid(n, "cpu"))
        np.testing.assert_array_equal(new.cpu().numpy(), i / np.float32(n))


# (N, K): check_iou's, test_pallas's, the NMS candidate shape; ragged tiles;
# K % 4 != 0 (the element-wise body), one row, one box.
IOU_CASES = [(300, 200), (50, 40), (128, 128), (200, 300), (2048, 2048), (7, 129), (33, 1),
             (300, 201), (50, 41), (129, 130), (2047, 2049), (4096, 4095), (1, 1), (1, 4096)]


def _iou_bit_exact(boxes, query, want_positive=True):
    """The kernel against the plain version at offsets 1.0 and 0.0, bit for
    bit (as int32 views, so -0 and +0 differ), one launch a call."""
    n, k = boxes.shape[0], query.shape[0]
    for offset in (1.0, 0.0):
        before = iou_kernel.LAUNCHES
        got = iou_kernel.bbox_overlaps_cuda(boxes, query, offset)
        assert iou_kernel.LAUNCHES == before + 1
        want = bbox_overlaps(boxes, query, offset)
        torch.cuda.synchronize()
        assert got.shape == (n, k) and got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert float(want.max()) > 0 or not want_positive


@pytest.mark.parametrize("n,k", IOU_CASES)
def test_iou_kernel_equals_plain(dev, n, k):
    boxes, query = (torch.from_numpy(b).to(dev) for b in iou_inputs(n * 7 + k, n, k))
    # One column or one row: only the degenerate box, so every IoU is 0.
    _iou_bit_exact(boxes, query, want_positive=k > 1 and n > 1)


@pytest.mark.parametrize("n,k", [(16385, 131072), (131071, 16385)])
def test_iou_kernel_64bit_indices(dev, n, k):
    """N * K just above ``INDEX32_MAX`` (8.6 GB of output), where the kernel
    takes its 64-bit indices, in the vector and the element-wise body; held
    bit for bit against the plain version a block of rows at a time."""
    assert n * k > iou_kernel.INDEX32_MAX
    boxes, query = (torch.from_numpy(b).to(dev) for b in iou_inputs(n + k, n, k))
    rows = 2**27 // k
    for offset in (1.0, 0.0):
        before = iou_kernel.LAUNCHES
        got = iou_kernel.bbox_overlaps_cuda(boxes, query, offset)
        assert iou_kernel.LAUNCHES == before + 1 and got.shape == (n, k)
        for i in range(0, n, rows):
            want = bbox_overlaps(boxes[i:i + rows], query, offset)
            assert torch.equal(got[i:i + rows].view(torch.int32), want.view(torch.int32)), i
        del got, want
        torch.cuda.empty_cache()


def test_iou_kernel_views_and_bf16(dev):
    """A column slice of an [N, 8] tensor (not contiguous), a contiguous view
    that starts 4 bytes off 16, and bf16 boxes (cast as the plain version
    casts them)."""
    boxes, query = (torch.from_numpy(b).to(dev) for b in iou_inputs(5, 300, 201))
    wide = torch.zeros((300, 8), device=dev)
    wide[:, 2:6] = boxes
    assert not wide[:, 2:6].is_contiguous()
    _iou_bit_exact(wide[:, 2:6], query)
    flat = torch.zeros(201 * 4 + 1, device=dev)
    flat[1:] = query.reshape(-1)
    shifted = flat[1:].view(201, 4)
    assert shifted.data_ptr() % 16 == 4
    _iou_bit_exact(boxes, shifted)
    _iou_bit_exact(boxes.bfloat16(), query.bfloat16())


def test_iou_kernel_above_the_old_row_cap(dev):
    """N = 2,100,000 > 65,535 x 32 (the old grid's cap), K = 3: 25 MB of
    output, computed."""
    boxes, query = (torch.from_numpy(b).to(dev) for b in iou_inputs(8, 2_100_000, 3))
    _iou_bit_exact(boxes, query)


def test_iou_kernel_rejects(dev):
    boxes = torch.zeros((4, 4), device=dev)
    with pytest.raises(ValueError, match="CUDA tensors"):
        iou_kernel.bbox_overlaps_cuda(boxes, boxes.cpu())
    with pytest.raises(ValueError, match=r"\[N, 4\]"):
        iou_kernel.bbox_overlaps_cuda(boxes[:, :3], boxes)
    with pytest.raises(TypeError, match="float"):
        iou_kernel.bbox_overlaps_cuda(boxes.int(), boxes)
    assert iou_kernel.bbox_overlaps_cuda(boxes[:0], boxes).shape == (0, 4)


def _small_trunk_cfg(backbone):
    return cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": backbone, "FC_DIM": 64, "NUM_TEMPLATES": 11,
                  "POOL_SIZE": 7 if backbone == "resnet50" else 6, "STEM_S2D": False,
                  "POOLING_MODE": "align_pallas"},
        "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 256, "MAX_LEVELS": 3, "NUM_PROPOSALS": 50},
        "TEST": {"SCALES": (64,), "MAX_SIZE": 128}})


@pytest.mark.parametrize("backbone", ["resnet50", "caffenet", "vgg_cnn_m_1024"])
def test_trunks_on_card_equal_cpu(dev, backbone):
    """The new trunks in bf16 with the fused ROI align: the trunk features on
    the card against the CPU (cuDNN and the CPU round bf16 sums apart: 2e-2
    of max |x|), and im_detect on the same boxes (scores 2e-2, boxes 0.5 px:
    through ResNet-50's 13 bf16 blocks the softmax moved by up to 1.26e-2 on
    an H100); the ROI-align kernel launches once per head call."""
    cfg = _small_trunk_cfg(backbone)
    cpu_net = tapi.build_frcnn_net(cfg, device="cpu")
    gpu_net = tapi.build_frcnn_net(cfg, state_dict=cpu_net.params, device=dev)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.uniform(-120, 120, (1, 64, 96, 3)).astype(np.float32))
    with torch.inference_mode():
        want = cpu_net.model.features(x).float()
        got = gpu_net.model.features(x.to(dev)).float().cpu()
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())
    im = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    xy = rng.uniform(0, 80, (40, 2))
    boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(8, 60, (40, 2)), 120)], 1)
    before = roi_align_kernel.LAUNCHES
    got = tapi.im_detect(gpu_net, im, boxes.astype(np.float32))
    assert roi_align_kernel.LAUNCHES - before == 1
    want = tapi.im_detect(cpu_net, im, boxes.astype(np.float32))
    np.testing.assert_allclose(got[0], want[0], atol=2e-2, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=0.5, rtol=0)


def test_int8_resnet_block_on_card_equals_cpu(dev):
    """An int8 bottleneck (stride 2, with its downsample): from the same bf16
    input, the card's int8 1x1 GEMMs (``torch._int_mm``) equal the CPU's, so
    the block outputs differ only by the bf16 3x3 conv's rounding."""
    torch.manual_seed(0)
    block = resnet.Bottleneck(256, 128, stride=2).eval()
    with torch.no_grad():
        for p in block.parameters():
            if p.ndim == 4:
                p.normal_(0, 0.05)
    block.prepare_int8()
    x = torch.relu(torch.randn(2, 256, 20, 26)).to(torch.bfloat16)
    xq = tconv.quantize_acts(x, 0.03)
    w_q, s_w = block._int8["downsample"]
    want = tconv.conv1x1_int8(xq.permute(0, 2, 3, 1), 0.03, w_q, s_w)
    got = tconv.conv1x1_int8(xq.to(dev).permute(0, 2, 3, 1), 0.03, w_q.to(dev), s_w.to(dev))
    assert torch.equal(got.cpu(), want)
    with torch.no_grad():
        cpu = block(x, (0.03, 0.02)).float()
        gpu = block.to(dev)
        gpu.prepare_int8()
        card = gpu(x.to(dev), (0.03, 0.02)).float().cpu()
    assert float((card - cpu).abs().max()) <= 2e-2 * float(cpu.abs().max())


def _detect_cfg():
    return cfg_from_dict(Config(), {
        "MODEL": {"WIDTH": 0.25, "FC_DIM": 64, "NUM_TEMPLATES": 11,
                  "POOLING_MODE": "align_pallas", "FUSE_CONV1": True},
        "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 256, "MAX_LEVELS": 3, "NUM_PROPOSALS": 50},
        "TEST": {"SCALES": (64,), "MAX_SIZE": 128, "BBOX_ITER": 2}})


def test_float32_net_under_callers_tf32_equals_cpu(dev):
    """A float32 VGG-16 (WIDTH 0.25) built and run with TF32 turned ON for
    both cuDNN and cuBLAS, as a caller may leave them (this test turns them
    on and restores them; the other tests run under PyTorch's defaults): the port scopes its
    own precision, so the trunk holds the CPU's to 1e-4 of max |x|
    (``chip_smoke.py``'s ``card_vs_cpu`` bound) and the flags come back."""
    cfg = cfg_from_dict(Config(), {"MODEL": {"WIDTH": 0.25, "FC_DIM": 64,
                                             "COMPUTE_DTYPE": "float32"}})
    prev = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        cpu_net = tapi.build_az_net(cfg, device="cpu")
        gpu_net = tapi.build_az_net(cfg, state_dict=cpu_net.params, device=dev)
        x = torch.from_numpy(np.random.RandomState(1).uniform(-120, 120, (2, 64, 96, 3))
                             .astype(np.float32))
        with torch.inference_mode():
            want = cpu_net.model.features(x)
            got = gpu_net.model.features(x.to(dev)).cpu()
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


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
    before = launch_counts()
    got = tapi.im_detect(gpu_net, im, boxes.astype(np.float32))
    after = launch_counts()
    assert after["roi_align"] - before["roi_align"] == 2 and after["conv1"] - before["conv1"] == 1
    want = tapi.im_detect(cpu_net, im, boxes.astype(np.float32))
    np.testing.assert_allclose(got[0], want[0], atol=1e-2, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=0.5, rtol=0)


def _matched(a, b, s_tol=1e-5, b_tol=2e-3):
    """Rows of ``a [N, 5]`` with a row of ``b`` within the bounds."""
    if not (len(a) and len(b)):
        return np.zeros(len(a), bool)
    return ((np.abs(a[:, None, :4] - b[None, :, :4]).max(-1) <= b_tol)
            & (np.abs(a[:, None, 4] - b[None, :, 4]) <= s_tol)).any(1)


def test_eval_drivers_on_card_equal_cpu(dev):
    """The dataset drivers (``eval/detection.py``) on the card against the
    port on the CPU at ``tests/test_torch_eval.py``'s size (smallnet f32, 4
    classes, three 192x256 synthetic images, batch 2, one tail batch), with
    ``'align_pallas'`` so that the ROI-align kernel runs beside NMS, at that
    file's bounds: proposals the same count, sorted scores to 1e-5, each box
    within 2e-3 px of a box of the other side (near-tied scores may swap two
    rows); detections the same count per class and image, each row within
    those bounds of a row of the other side; recall within one gt match."""
    from aznet_tpu_torch.data import SyntheticImdb
    from aznet_tpu_torch.eval import detection as tdet

    cfg = cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 32, "NUM_TEMPLATES": 5, "NUM_CLASSES": 4,
                  "COMPUTE_DTYPE": "float32", "POOLING_MODE": "align_pallas"},
        "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 2, "NUM_PROPOSALS": 10},
        "TEST": {"SCALES": (64,), "MAX_SIZE": 128}})
    imdb = SyntheticImdb(split="test", seed=2, num_images=3)
    cpu_az = tapi.build_az_net(cfg, device="cpu")
    cpu_fr = tapi.share_trunk(tapi.build_frcnn_net(cfg, device="cpu", seed=1), cpu_az)
    gpu_az = tapi.build_az_net(cfg, state_dict=cpu_az.params, device=dev)
    gpu_fr = tapi.share_trunk(tapi.build_frcnn_net(cfg, state_dict=cpu_fr.params, device=dev),
                              gpu_az)
    out = {}
    before = launch_counts()
    for key, (az, fr) in (("card", (gpu_az, gpu_fr)), ("cpu", (cpu_az, cpu_fr))):
        out[key] = [tdet.propose_all(az, imdb), tdet.propose_all_batched(az, imdb, batch_size=2),
                    tdet.detect_all(az, fr, imdb),
                    tdet.detect_all_batched(az, fr, imdb, batch_size=2),
                    tdet.detect_all_batched(az, fr, imdb, batch_size=2, fused=False),
                    tdet.evaluate_recall(az, imdb, top_ks=(5, 10), batched=True, batch_size=2,
                                         refine_net=fr)]
        if key == "card":
            after = launch_counts()
            launched = tuple(after[k] - before[k] for k in ("nms", "roi_align"))
    assert launched[0] >= 12 and launched[1] >= 12, launched
    got, want = out["card"], out["cpu"]
    for g_props, w_props in zip(got[:2], want[:2]):
        for g, w in zip(g_props, w_props):
            assert g.shape == w.shape and len(g) > 0
            np.testing.assert_allclose(np.sort(g[:, 4]), np.sort(w[:, 4]), atol=1e-5, rtol=0)
            assert _matched(g, w, np.inf).all() and _matched(w, g, np.inf).all()
    total = 0
    for g_boxes, w_boxes in zip(got[2:5], want[2:5]):
        for c in range(1, 4):
            for g, w in zip(g_boxes[c], w_boxes[c]):
                assert g.shape == w.shape
                assert _matched(g, w).all() and _matched(w, g).all()
                total += len(g)
    assert total > 0
    n_gt = sum(int((~e["difficult"]).sum()) for e in imdb.roidb)
    for k in want[5]:
        for t in want[5][k]:
            assert abs(got[5][k][t] - want[5][k][t]) <= 1.0 / n_gt


def _train_batch(seed, hw=(64, 96), b=2, r=16, k=11):
    rng = np.random.RandomState(seed)
    rois = rng.uniform(0, 40, (b, r, 4)).astype(np.float32)
    rois[..., 2:] += rng.uniform(16, 40, (b, r, 2)).astype(np.float32)
    return {
        "images": rng.uniform(-100, 100, (b,) + hw + (3,)).astype(np.float32),
        "rois": rois,
        "roi_valid": np.ones((b, r), bool),
        "zoom_labels": rng.randint(0, 2, (b, r)).astype(np.float32),
        "adj_labels": rng.randint(0, 2, (b, r, k)).astype(np.float32),
        "adj_targets": rng.normal(0, 0.1, (b, r, k, 4)).astype(np.float32),
        "adj_inside": np.ones((b, r, k, 4), np.float32),
    }


def test_train_step_on_card_equals_cpu(dev):
    """One bf16 AZ step of VGG-16 at WIDTH 0.25 (DROPOUT 0) on the card and on
    the CPU from the same weights and batch, at the bf16 bounds of
    tests/test_torch_train.py: loss and metrics to 1e-2 relative, each
    parameter's update at a cosine above 0.95 and its norm within 15%."""
    from aznet_tpu_torch.train import train_az

    cfg = cfg_from_dict(Config(), {"MODEL": {"WIDTH": 0.25, "FC_DIM": 64, "DROPOUT": 0.0}})
    cpu = train_az.make_az_train_state(cfg, device="cpu")
    card = train_az.make_az_train_state(cfg, device=dev, state_dict=cpu.model.state_dict())
    before = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    batch = _train_batch(0)
    m_cpu = train_az.make_az_train_step(cpu.model)(cpu, batch, 0)
    m_card = train_az.make_az_train_step(card.model)(card, batch, 0)
    for key in m_cpu:
        a, b = float(m_card[key]), float(m_cpu[key])
        assert abs(a - b) <= 1e-2 * max(abs(b), 1e-3), (key, a, b)
    after = card.model.state_dict()
    for k, p in cpu.model.state_dict().items():
        want = (p - before[k]).double().ravel()
        got = (after[k].cpu() - before[k]).double().ravel()
        cos = float(got @ want / (got.norm() * want.norm()))
        assert cos > 0.95 and abs(float(got.norm() / want.norm()) - 1) <= 0.15, (k, cos)


def test_fuse_conv1_under_grad_raises_on_card(dev):
    """The fused conv1 kernel has no backward: a training net with
    FUSE_CONV1 raises where autograd records, and launches it under
    no_grad."""
    from aznet_tpu_torch.train import train_az

    cfg = cfg_from_dict(Config(), {"MODEL": {"WIDTH": 0.25, "FC_DIM": 64, "FUSE_CONV1": True}})
    state = train_az.make_az_train_state(cfg, device=dev)
    batch = train_az.to_device(_train_batch(1), dev)
    with pytest.raises(RuntimeError, match="FUSE_CONV1"):
        train_az.az_loss(state.model, batch)
    before = conv1_kernel.LAUNCHES
    with torch.no_grad():
        loss, _ = train_az.az_loss(state.model, batch)
    assert conv1_kernel.LAUNCHES == before + 1 and torch.isfinite(loss)


def test_prefetch_workers_leave_cuda_uninitialised(dev):
    """With CUDA live in the parent, two spawned prefetch workers build
    batches with the card hidden and CUDA never initialised; the parent's
    environment comes back as it was."""
    import os

    from aznet_tpu_torch.data.prefetch import MPPrefetcher, az_batch_builder

    torch.zeros(1, device=dev)
    assert torch.cuda.is_initialized()
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    cfg = cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "smallnet"},
        "TRAIN": {"SCALES": [96], "MAX_SIZE": 128, "REGIONS_PER_IMAGE": 32,
                  "USE_FLIPPED": False}})
    pf = MPPrefetcher(az_batch_builder, {"imdb_name": "synthetic_train", "cfg": cfg, "seed": 7,
                                         "pid": 0, "pcount": 1, "ims_local": 2}, workers=2)
    try:
        batches = [pf.next() for _ in range(4)]
    finally:
        pf.close()
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == saved
    assert all(b["images"].shape == (2, 96, 128, 3) for b in batches)
    assert sorted(pf.worker_env) == [0, 1]
    for env in pf.worker_env.values():
        assert (env["jax_imported"], env["cuda_initialized"],
                env["cuda_visible_devices"]) == (False, False, ""), env


def test_trace_puts_the_spans_on_the_profiler_clock(dev, tmp_path):
    """``profiling.trace``'s ``spans.json`` on a card: the marker kernel's
    offset takes a span onto ``trace.json``'s clock, where every kernel but
    the marker (the matmul and the sum the span launched and waited for)
    lies inside it."""
    import json
    import time

    from aznet_tpu_torch.utils import profiling

    x = torch.randn(2048, 2048, device=dev)
    (x @ x).sum().item()  # cuBLAS loaded before the trace
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer"):
            time.sleep(0.002)  # the host alone: the kernels lie in "inner" only
            with profiling.span("inner", rows=2048):
                (x @ x).sum()
                torch.cuda.synchronize()
    record = json.loads((tmp_path / "spans.json").read_text())
    chrome = json.loads((tmp_path / "trace.json").read_text())
    offset, base = record["profiler_offset_ns"], chrome["baseTimeNanoseconds"]
    assert isinstance(offset, int) and record["dropped"] == 0
    inner = next(s for s in record["spans"] if s["name"] == "inner")
    kernels = [e for e in chrome["traceEvents"]
               if e.get("cat") == "kernel" and "spin" not in e["name"].lower()]
    assert kernels
    for e in kernels:
        start = e["ts"] * 1000 + base - offset
        end = start + e["dur"] * 1000
        assert inner["start"] - 100e3 < start and end < inner["end"] + 100e3, (e["name"], inner)
