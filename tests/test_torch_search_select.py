"""The search's seed and selection kernels (``csrc/search_select.cu``)
against the plain ``search/propose.py::seed_plain`` and ``select_plain`` on
the card, bit for bit: the seed at both benchmark configurations and
SEED_LEVELS 0-2 with every kind of extent, the selection with and without
the CAND_BUF cap, ties, +-0 and subnormal scores, no live row, few kept rows,
NUM_PROPOSALS above CAND_BUF and more than 16384 candidates, whole searches
and the launch counts. On the CPU: NumPy models of the kernels' rules (the
rank by counting, the seed's walk down its base-5 digits) against
``ops/topk.py::top_k``, ``ops/nms.py::nms_topk`` and ``init_frontier``, and
the CPU path, which never loads the library. Imports no JAX, so it runs
where JAX is absent:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_search_select.py

Without a CUDA device the ``cuda`` tests skip (the kernels have no CPU mode).
"""

import dataclasses

import numpy as np
import pytest
import torch

from _search_level_cases import K, SEARCH_CONFIGS, stand_in_head
from aznet_tpu_torch import _build
from aznet_tpu_torch.ops import nms as tnms
from aznet_tpu_torch.ops.cuda import nms_kernel
from aznet_tpu_torch.ops.cuda import search_select_kernel as ssk
from aznet_tpu_torch.ops.topk import top_k
from aznet_tpu_torch.search import propose
from aznet_tpu_torch.search.templates import division_table

NEG_INF = np.float32(propose.NEG_INF)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    """Raw bits, so that -0 and +0 differ."""
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(got, want, what):
    assert len(got) == len(want) == len(what)
    for g, w, name in zip(got, want, what):
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape, g.dtype)
        assert torch.equal(_bits(g), _bits(w)), (
            f"{name}: {int((_bits(g) != _bits(w)).sum())} of {g.numel()} differ")


# -- NumPy models of the kernels' rules -------------------------------------

def rank_keys(scores: np.ndarray) -> np.ndarray:
    """The kernels' 64-bit key: the float32 total-order image of the score
    above ~index (``rank_key`` in the source)."""
    u = scores.astype(np.float32).view(np.uint32).astype(np.uint64)
    order = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    j = np.arange(scores.shape[0], dtype=np.uint64)
    return (order << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - j)


def places(keys: np.ndarray) -> np.ndarray:
    """Each row's place: the number of rows with a larger key, counted in
    chunks of the kernel's 2048 keys."""
    out = np.zeros(keys.shape[0], np.int64)
    for c0 in range(0, keys.shape[0], 2048):
        out += (keys[c0:c0 + 2048][None, :] > keys[:, None]).sum(1)
    return out


def model_cap(boxes, scores, cap, thresh):
    """``search_cap_kernel``: (boxes, final, live) as NumPy."""
    if scores.shape[0] > cap:
        p = places(rank_keys(scores))
        rows = np.flatnonzero(p < cap)
        order = np.empty(cap, np.int64)
        order[p[rows]] = rows
        boxes, scores = boxes[order], scores[order]
    final = np.where(scores >= np.float32(thresh), scores, NEG_INF).astype(np.float32)
    return boxes, final, final > NEG_INF


def model_topk(keep, final, boxes, k):
    """``search_topk_kernel``: (boxes, scores, valid) as NumPy."""
    keys = np.where(keep, rank_keys(final), np.uint64(0))
    p = places(keys)
    out_b, out_s, out_v = np.zeros((k, 4), np.float32), np.zeros(k, np.float32), np.zeros(k, bool)
    for i in np.flatnonzero(keep & (p < k)):
        out_b[p[i]], out_s[p[i]], out_v[p[i]] = boxes[i], final[i], True
    return out_b, out_s, out_v


def model_seed(h, w, divisions, n_seed, cap, offset):
    """``search_seed_kernel``'s frontier: row i walks from the whole image
    down the base-5 digits of its index in its level, most significant
    first, each step float32 operations rounded one at a time."""
    f32 = np.float32
    off = f32(offset)
    out = np.zeros((cap, 4), np.float32)
    for i in range(n_seed):
        first, count = 0, 1
        while i >= first + count:
            first, count = first + count, count * 5
        j = i - first
        b = [f32(0.0), f32(0.0), f32(w) - off, f32(h) - off]
        count //= 5
        while count:
            t = divisions[(j // count) % 5]
            bw, bh = (b[2] - b[0]) + off, (b[3] - b[1]) + off
            b = [b[0] + t[0] * bw, b[1] + t[1] * bh, (b[0] + t[2] * bw) - off,
                 (b[1] + t[3] * bh) - off]
            count //= 5
        out[i] = b
    return out, np.arange(cap) < n_seed


def adversarial_scores(rng, n):
    """Ties, +-0, subnormals of both signs, +-inf, NaNs of both signs,
    NEG_INF and ordinary scores, shuffled."""
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, np.inf, -np.inf, NEG_INF,
                        0.5, 0.5, 0.25, -0.25, 1.0], np.float32)
    nan = np.array([0x7FC00000, 0xFFC00000, 0x7F800001], np.uint32).view(np.float32)
    pool = np.concatenate([special, nan, rng.rand(8).astype(np.float32)])
    x = pool[rng.randint(0, pool.shape[0], n)]
    ordinary = rng.rand(n) < 0.3
    x[ordinary] = rng.rand(int(ordinary.sum()))
    return x


@pytest.mark.parametrize("n", [1, 7, 64, 2047, 2048, 2049, 5000])
def test_rank_rule_matches_top_k(n):
    """The rank by counting gives ``top_k``'s order, values to the bit."""
    rng = np.random.RandomState(n)
    x = adversarial_scores(rng, n)
    p = places(rank_keys(x))
    assert sorted(p) == list(range(n))  # a permutation: places are distinct
    order = np.argsort(p)
    values, idx = top_k(torch.from_numpy(x), n)
    np.testing.assert_array_equal(order, idx.numpy())
    np.testing.assert_array_equal(x[order].view(np.uint32), values.numpy().view(np.uint32))


@pytest.mark.parametrize("n,cap,thresh", [(3256, 2048, 0.05), (300, 512, 0.05),
                                          (2500, 1000, 0.0), (2500, 1000, -1e-3)])
def test_cap_model_matches_select_plain(n, cap, thresh):
    """The cap kernel's rule against ``select_plain``'s cap and threshold on
    the CPU, with a tie-heavy, +-0 and subnormal score vector."""
    rng = np.random.RandomState(n + cap)
    x = adversarial_scores(rng, n)
    x[np.isnan(x)] = 0.125  # the search's scores are sigmoids: NaN-free
    boxes = rng.uniform(0, 500, (n, 4)).astype(np.float32)
    got = model_cap(boxes, x, cap, thresh)
    scores, b = torch.from_numpy(x), torch.from_numpy(boxes)
    if n > cap:
        scores, idx = top_k(scores, cap)
        b = b[idx]
    final = torch.where(scores >= thresh, scores, propose.NEG_INF)
    for g, w in zip(got, (b, final, final > propose.NEG_INF)):
        np.testing.assert_array_equal(np.ascontiguousarray(g).view(np.uint8),
                                      w.numpy().view(np.uint8))


@pytest.mark.parametrize("n,k,kept_share", [(2048, 300, 0.4), (4096, 1000, 0.05),
                                            (256, 1000, 0.5), (100, 300, 0.0)])
def test_topk_model_matches_nms_topk(monkeypatch, n, k, kept_share):
    """The top-k kernel's rule against ``nms_topk`` given NMS's keep mask
    (kept rows live, as NMS keeps them): ranks by ``final``, ties to the
    lower index, zero rows past the kept ones, padded to k."""
    rng = np.random.RandomState(n + k)
    final = np.round(rng.rand(n) * 8).astype(np.float32) / 8  # ties
    final[rng.rand(n) < 0.1] = np.float32(-0.0)
    final[rng.rand(n) < 0.1] = NEG_INF
    keep = (rng.rand(n) < kept_share) & (final > NEG_INF)
    boxes = rng.uniform(0, 500, (n, 4)).astype(np.float32)
    monkeypatch.setattr(tnms, "nms_mask", lambda *a, **kw: torch.from_numpy(keep))
    want = tnms.nms_topk(torch.from_numpy(boxes), torch.from_numpy(final), 0.7, k,
                         valid=torch.from_numpy(final > NEG_INF))
    for g, w in zip(model_topk(keep, final, boxes, k), want):
        np.testing.assert_array_equal(g.view(np.uint8), w.numpy().view(np.uint8))


@pytest.mark.parametrize("levels", [0, 1, 2, 3])
@pytest.mark.parametrize("overlap,offset", [(0.0, 1.0), (0.1, 1.0), (0.0, 0.0)])
def test_seed_model_matches_init_frontier(levels, overlap, offset):
    scfg = propose.SearchConfig(SEED_LEVELS=levels, DIV_OVERLAP=overlap, FRONTIER_CAP=256)
    n, cap = propose.seed_count(levels), propose.frontier_schedule(scfg)[0]
    for h, w in ((600, 800), (1080, 1920), (37, 1001)):
        boxes, valid = propose.init_frontier(torch.tensor(h, dtype=torch.int32), w, scfg,
                                             offset, cap=cap)
        m_boxes, m_valid = model_seed(h, w, division_table(overlap), n, cap, offset)
        np.testing.assert_array_equal(m_boxes.view(np.uint32), boxes.numpy().view(np.uint32))
        np.testing.assert_array_equal(m_valid, valid.numpy())


def test_cpu_search_takes_the_plain_path(monkeypatch):
    """A CPU feature map runs the plain seed and selection: the library is
    never loaded and the counter does not move."""
    def refuse():
        raise AssertionError("the CPU path loaded the kernel library")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(ssk, "_fns", None)
    scfg = dataclasses.replace(SEARCH_CONFIGS["vgg16"][0], MAX_LEVELS=3, CAND_BUF=256)
    before = ssk.LAUNCHES
    boxes, scores, valid = propose.az_search(stand_in_head(), torch.zeros((8, 8, 8)),
                                             (torch.tensor(200, dtype=torch.int32), 300),
                                             scfg, K)
    assert ssk.LAUNCHES == before
    assert boxes.shape == (scfg.NUM_PROPOSALS, 4) and valid.any()


def test_wrappers_refuse_cpu_tensors():
    scores = torch.rand(64)
    boxes = torch.rand(64, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssk.search_cap_cuda(boxes, scores, 32, 0.05, propose.NEG_INF)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssk.search_topk_cuda(scores > 0.5, scores, boxes, 10)
    with pytest.raises(ValueError, match="CUDA device"):
        ssk.search_seed_cuda(600, 800, division_table(0.0), 6, 8, 88, offset=1.0,
                             neg_inf=propose.NEG_INF, device=torch.device("cpu"))


def test_seed_cuda_refuses_too_many_seeds():
    """As ``init_frontier`` does, before any launch."""
    scfg = propose.SearchConfig(SEED_LEVELS=2)
    with pytest.raises(ValueError, match="31 seed regions > FRONTIER_CAP=8"):
        propose.seed_cuda((600, 800), scfg, 1.0, 8, 100, torch.device("cpu"))


# -- On the card ----------------------------------------------------------

def _extent(kind, v, dev):
    return {"int32": lambda: torch.tensor(v, dtype=torch.int32, device=dev),
            "int64": lambda: torch.tensor(v, dtype=torch.int64, device=dev),
            "float32": lambda: torch.tensor(float(v), device=dev),
            "float64": lambda: torch.tensor(v + 0.3, dtype=torch.float64, device=dev),
            "bfloat16": lambda: torch.tensor(float(v), dtype=torch.bfloat16, device=dev),
            "cpu": lambda: torch.tensor(v, dtype=torch.int32),
            "int": lambda: v,
            "float": lambda: v + 0.7}[kind]()


SEED_CASES = [(config, levels, kind, overlap)
              for config in sorted(SEARCH_CONFIGS) for levels in (0, 1, 2)
              for kind, overlap in (("int32", 0.0), ("int", 0.0), ("float32", 0.1),
                                    ("float64", 0.0), ("int64", 0.0), ("bfloat16", 0.0),
                                    ("cpu", 0.0), ("float", 0.0))]


@pytest.mark.cuda
@pytest.mark.parametrize("config,levels,kind,overlap", SEED_CASES)
def test_seed_kernel_matches_plain(dev, config, levels, kind, overlap):
    """The seed frontier, its valid flags, the extent and the filled
    candidate buffers, at each configuration's schedule and image size."""
    scfg, (h, w) = SEARCH_CONFIGS[config]
    scfg = dataclasses.replace(scfg, SEED_LEVELS=levels, DIV_OVERLAP=overlap)
    cap = propose.frontier_schedule(scfg)[0]
    total = propose.candidate_starts(scfg, K)[1]
    hw = (_extent(kind, h - 13, dev), _extent(kind, w - 7, dev))
    got = propose.seed_cuda(hw, scfg, 1.0, cap, total, dev)
    want = propose.seed_plain(hw, scfg, 1.0, cap, total, dev)
    _assert_same(got, want, ("extent", "f_boxes", "f_valid", "cand_boxes", "cand_scores"))
    assert int(got[2].sum()) == propose.seed_count(levels)


def _candidates(n, dev, seed, kind="random"):
    """A candidate buffer of ``n`` rows as a search leaves it: boxes inside
    a 1080x1920 image, sigmoid scores, NEG_INF rows. ``kind``: ``ties``
    scores on eight levels; ``signed_zero`` +-0 and subnormal scores of both
    signs; ``dead`` NEG_INF everywhere; ``crowd`` a few distinct boxes, so
    that NMS keeps few rows."""
    rng = np.random.RandomState(seed)
    x1, y1 = rng.uniform(0, 1800, n), rng.uniform(0, 1000, n)
    side = np.exp(rng.uniform(np.log(8), np.log(600), (n, 2)))
    boxes = np.stack([x1, y1, x1 + side[:, 0], y1 + side[:, 1]], 1).astype(np.float32)
    scores = (1 / (1 + np.exp(-rng.normal(0, 2, n)))).astype(np.float32)
    if kind == "ties":
        scores = np.round(scores * 8).astype(np.float32) / 8
    elif kind == "signed_zero":
        pool = np.array([0.0, -0.0, 1e-45, -1e-45, 3e-39, -3e-39, 0.5], np.float32)
        scores = pool[rng.randint(0, pool.shape[0], n)]
    elif kind == "crowd":
        boxes = boxes[rng.randint(0, 4, n)]
    scores[rng.rand(n) < 0.2] = NEG_INF
    if kind == "dead":
        scores[:] = NEG_INF
    return torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)


SELECT_CASES = [
    # (rows, CAND_BUF, NUM_PROPOSALS, CONF_THRESH, kind)
    (3256, 2048, 300, 0.05, "random"),    # VGG-16's buffer, capped
    (7480, 4096, 1000, 0.05, "random"),   # ResNet-50's, capped
    (3256, 3256, 300, 0.05, "random"),    # CAND_BUF at the row count: no cap
    (3256, 4096, 300, 0.05, "random"),    # above it
    (7480, 4096, 1000, 0.05, "ties"),
    (3256, 2048, 300, 0.0, "signed_zero"),
    (3256, 2048, 300, -1e-3, "signed_zero"),
    (1000, 2048, 300, -1e-3, "signed_zero"),
    (7480, 4096, 1000, 0.05, "dead"),
    (3256, 2048, 300, 0.05, "crowd"),     # fewer kept rows than NUM_PROPOSALS
    (3256, 256, 1000, 0.05, "random"),    # NUM_PROPOSALS > CAND_BUF
    (20000, 4096, 1000, 0.05, "random"),  # more than 16384 candidates
    (20000, 32768, 1000, 0.05, "ties"),   # ... uncapped: NMS's large route
    (1, 1, 5, 0.05, "random"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cand_buf,num,thresh,kind", SELECT_CASES)
def test_select_kernels_match_plain(dev, rows, cand_buf, num, thresh, kind):
    scfg = dataclasses.replace(SEARCH_CONFIGS["resnet50_1080p"][0], CAND_BUF=cand_buf,
                               NUM_PROPOSALS=num, CONF_THRESH=thresh)
    for seed in (0, 1):
        c_boxes, c_scores = _candidates(rows, dev, seed + rows, kind)
        got = propose.select_cuda(c_boxes, c_scores, scfg, 1.0)
        want = propose.select_plain(c_boxes, c_scores, scfg, 1.0)
        _assert_same(got, want, ("boxes", "scores", "valid"))
        if kind == "dead":
            assert not got[2].any()
        elif kind == "crowd":
            assert 0 < int(got[2].sum()) < num
        elif rows > 1:
            assert got[2].any()


def _search(feat, hw, scfg):
    cand = propose.search_candidates(stand_in_head(), feat, hw, scfg, K, 1.0, True)
    return (*cand, *propose.az_search(stand_in_head(), feat, hw, scfg, K, 1.0, True))


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(SEARCH_CONFIGS))
def test_search_kernels_match_plain(dev, config, monkeypatch):
    """Whole searches on the card, the seed and selection kernels against
    the plain versions, at each configuration's SEAR on three images, the
    extents as int32 card tensors (as the preprocess gives them) and as
    Python ints: the candidate buffer, every level's frontier and the
    proposals, bit for bit."""
    scfg, (h, w) = SEARCH_CONFIGS[config]
    names = ("cand_boxes", "cand_scores", "visited", "visited_valid", "boxes", "scores",
             "valid", "visited", "visited_valid")
    for seed in range(3):
        rng = np.random.RandomState(seed)
        vh, vw = h - rng.randint(0, h // 4), w - rng.randint(0, w // 4)
        hw = ((torch.tensor(vh, dtype=torch.int32, device=dev),
               torch.tensor(vw, dtype=torch.int32, device=dev)) if seed != 1 else (vh, vw))
        feat = torch.from_numpy(rng.randn(h // 16, w // 16, 8).astype(np.float32)).to(dev)
        got = _search(feat, hw, scfg)
        with monkeypatch.context() as m:
            m.setattr(propose, "seed_cuda", propose.seed_plain)
            m.setattr(propose, "select_cuda", propose.select_plain)
            want = _search(feat, hw, scfg)
        _assert_same(got, want, names)
        assert got[6].sum() > 50


@pytest.mark.cuda
def test_launches_three_per_search(dev):
    scfg, (h, w) = SEARCH_CONFIGS["vgg16"]
    feat = torch.zeros((h // 16, w // 16, 8), device=dev)
    for searches in (1, 3):
        before, nms_before = ssk.LAUNCHES, nms_kernel.LAUNCHES
        for _ in range(searches):
            propose.az_search(stand_in_head(), feat, (h, w), scfg, K)
        assert ssk.LAUNCHES - before == 3 * searches
        assert nms_kernel.LAUNCHES - nms_before == searches


@pytest.mark.cuda
def test_kernels_refuse(dev):
    boxes, scores = _candidates(100, dev, 0)
    with pytest.raises(TypeError):
        ssk.search_cap_cuda(boxes, scores.double(), 32, 0.05, propose.NEG_INF)
    shifted = torch.zeros(401, device=dev)[1:].view(100, 4)  # 4 bytes past an alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssk.search_cap_cuda(shifted, scores, 32, 0.05, propose.NEG_INF)
    with pytest.raises(ValueError, match="one number"):
        ssk.search_seed_cuda(torch.zeros(2, device=dev), 800, division_table(0.0), 6, 8, 88,
                             offset=1.0, neg_inf=propose.NEG_INF, device=dev)
    with pytest.raises(ValueError, match="do not fit"):
        ssk.search_seed_cuda(600, 800, division_table(0.0), 9, 8, 88, offset=1.0,
                             neg_inf=propose.NEG_INF, device=dev)
