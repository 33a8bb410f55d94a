"""On a card: the CUDA kernels against their plain PyTorch versions, bit for
bit (NMS keep masks; int8 conv codes and bf16 exits). Imports no JAX, so it
runs where JAX is absent:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips (the kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

from aznet_tpu_torch.models.heads import int8_matmul
from aznet_tpu_torch.models.vgg import VGG16Trunk
from aznet_tpu_torch.ops import conv_int8 as tconv
from aznet_tpu_torch.ops import nms as tnms
from aznet_tpu_torch.ops.cuda import conv_int8_kernel, nms_kernel

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
