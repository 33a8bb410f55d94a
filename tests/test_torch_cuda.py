"""On a card: the CUDA NMS kernel against its plain PyTorch version, keep
masks bit for bit. Imports no JAX, so it runs where JAX is absent:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips (the kernel has no CPU mode).
"""

import numpy as np
import pytest
import torch

from aznet_tpu_torch.ops import nms as tnms
from aznet_tpu_torch.ops.cuda import nms_kernel

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
