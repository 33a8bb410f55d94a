"""The search-level kernel (``csrc/search_level.cu``) against the plain
``search/propose.py::level_step`` on the card, bit for bit: one level's
candidates (written into the candidate buffer at their rows) and next
frontier, whole searches at the benchmark configurations' SEAR settings, the
launch count, and the kernel's expf and sigmoid against ``torch.exp`` and
``torch.sigmoid`` over every float32 (through a probe library built here).
Imports no JAX, so it runs where JAX is absent:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_search_level.py

Without a CUDA device the ``cuda`` tests skip (the kernel has no CPU mode);
the wrapper's checks that need no card run everywhere.
"""

import ctypes
import dataclasses
import subprocess

import numpy as np
import pytest
import torch

from _search_level_cases import (CASES, K, SEARCH_CONFIGS, level_case, schedule_steps,
                                 stand_in_head)
from aznet_tpu_torch.ops.cuda import search_level_kernel as slk
from aznet_tpu_torch.search import propose

SENTINEL = 7.0  # candidate rows the level must not touch keep it


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    """Raw bits, so that -0 and +0 differ."""
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(got, want, what):
    for g, w, name in zip(got, want, what):
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape)
        assert torch.equal(_bits(g), _bits(w)), (
            f"{name}: {int((_bits(g) != _bits(w)).sum())} of {g.numel()} differ")


def _level_both(out, f_boxes, f_valid, next_cap, consts, start=5):
    """The kernel and ``level_plain`` on one level, each into its own
    candidate buffer of SENTINEL rows."""
    n = start + f_boxes.shape[0] * K + 3
    bufs = [(torch.full((n, 4), SENTINEL, device=f_boxes.device),
             torch.full((n,), SENTINEL, device=f_boxes.device)) for _ in range(2)]
    kernel = propose.level_cuda(out, f_boxes, f_valid, next_cap, consts, *bufs[0], start)
    plain = propose.level_plain(out, f_boxes, f_valid, next_cap, consts, *bufs[1], start)
    torch.cuda.synchronize()
    return (*bufs[0], *kernel), (*bufs[1], *plain)


LEVELS = sorted({("random", r, c) for cfg, _ in SEARCH_CONFIGS.values()
                 for r, c in schedule_steps(cfg)}
                | {(case, r, 0) for case in CASES for r in (8, 32, 64, 128)})


@pytest.mark.cuda
@pytest.mark.parametrize("case,r,next_cap", LEVELS)
def test_kernel_matches_level_step(dev, case, r, next_cap):
    """Each schedule step of both configurations, and every case at R = 8,
    32, 64 and 128 (next_cap 0: R, or 8R for ``pad``), K = 11, two seeds."""
    for seed in (0, 1):
        out, f_boxes, f_valid, cap, consts = level_case(case, r, seed + r, dev)
        got, want = _level_both(out, f_boxes, f_valid, next_cap or cap, consts)
        _assert_same(got, want, ("cand_boxes", "cand_scores", "next_boxes", "next_valid"))
        if case == "all_invalid":
            assert not got[3].any()
        if case == "random":
            assert got[3].any()
        if case == "pad":
            assert not got[3][5 * r:].any() and not got[2][5 * r:].any()


def _search(feat, hw, scfg, collect=True):
    cand = propose.search_candidates(stand_in_head(), feat, hw, scfg, K, 1.0, collect)
    return (*cand, *propose.az_search(stand_in_head(), feat, hw, scfg, K, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(SEARCH_CONFIGS))
def test_search_kernel_matches_eager(dev, config, monkeypatch):
    """The whole search on the card, kernel against eager, at each
    configuration's SEAR on three images: the candidate buffer, every level's
    frontier (``collect_frontier``) and the proposals, bit for bit."""
    scfg, (h, w) = SEARCH_CONFIGS[config]
    for seed in range(3):
        rng = np.random.RandomState(seed)
        hw = (torch.tensor(float(h - rng.randint(0, h // 4)), device=dev),
              torch.tensor(float(w - rng.randint(0, w // 4)), device=dev))
        feat = torch.from_numpy(rng.randn(h // 16, w // 16, 8).astype(np.float32)).to(dev)
        got = _search(feat, hw, scfg)
        with monkeypatch.context() as m:
            m.setattr(propose, "level_cuda", propose.level_plain)
            want = _search(feat, hw, scfg)
        _assert_same(got, want, ("cand_boxes", "cand_scores", "visited", "visited_valid",
                                 "boxes", "scores", "valid"))
        # The tail ran (the shorter images run out of regions above MIN_SIZE
        # a level or two early).
        assert got[3].view(scfg.MAX_LEVELS, -1).any(1).sum() >= scfg.MAX_LEVELS - 2
        assert got[6].sum() > 50


@pytest.mark.cuda
def test_launches_one_per_level(dev):
    scfg, (h, w) = SEARCH_CONFIGS["vgg16"]
    head = stand_in_head()
    calls = []

    def counting(feat, rois):
        calls.append(rois.shape[0])
        return head(feat, rois)

    feat = torch.zeros((h // 16, w // 16, 8), device=dev)
    for min_size in (16.0, 150.0):  # every level; the frontier empties in the tail
        before, n = slk.LAUNCHES, len(calls)
        propose.az_search(counting, feat, (h, w), dataclasses.replace(scfg, MIN_SIZE=min_size),
                          K)
        assert slk.LAUNCHES - before == len(calls) - n
    assert len(calls) < 2 * scfg.MAX_LEVELS  # the second search stopped early


# The kernel's expf and sigmoid_f32 over x [n]: a probe library of this
# test's own that includes the kernel's source, so the shipped one holds no
# kernel for tests.
MATH_PROBE = r"""
#include "{source}"

__global__ void level_math_kernel(const float* x, float* exp_out, float* sig_out, long long n) {{
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {{
    exp_out[i] = expf(x[i]);
    sig_out[i] = sigmoid_f32(x[i]);
  }}
}}

extern "C" int level_math(const float* x, float* exp_out, float* sig_out, long long n,
                          cudaStream_t stream) {{
  level_math_kernel<<<65536, 256, 0, stream>>>(x, exp_out, sig_out, n);
  return cudaGetLastError();
}}
"""


def _math_probe(tmp_path):
    from aznet_tpu_torch import _build

    src, lib = tmp_path / "level_math.cu", tmp_path / "level_math.so"
    src.write_text(MATH_PROBE.format(source=_build.SRC_DIR / "search_level.cu"))
    res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    fn = ctypes.CDLL(str(lib)).level_math
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x):
        e, s = torch.empty_like(x), torch.empty_like(x)
        assert fn(x.data_ptr(), e.data_ptr(), s.data_ptr(), x.numel(),
                  torch.cuda.current_stream().cuda_stream) == 0
        return e, s

    return run


@pytest.mark.cuda
def test_level_math_matches_torch(dev, tmp_path):
    """The kernel's expf and sigmoid against torch.exp and torch.sigmoid on
    every float32 bit pattern (NaNs only as NaNs)."""
    level_math = _math_probe(tmp_path)
    chunk = 1 << 28
    for lo in range(-(1 << 31), 1 << 31, chunk):
        x = torch.arange(lo, lo + chunk, dtype=torch.int32, device=dev).view(torch.float32)
        e, s = level_math(x)
        for got, want, name in ((e, torch.exp(x), "exp"), (s, torch.sigmoid(x), "sigmoid")):
            nan = torch.isnan(want)
            assert torch.equal(torch.isnan(got), nan), name
            bad = (_bits(got) != _bits(want)) & ~nan
            if bad.any():
                ulps = (_bits(got)[bad].long() - _bits(want)[bad].long()).abs().max()
                pytest.fail(f"{name}: {int(bad.sum())} inputs from {lo:#x} differ, "
                            f"up to {int(ulps)} ulp")
        del x, e, s


@pytest.mark.cuda
def test_kernel_refuses(dev):
    out, f_boxes, f_valid, cap, consts = level_case("random", 8, 0, dev)
    buf = (torch.zeros((8 * K, 4), device=dev), torch.zeros(8 * K, device=dev))
    with pytest.raises(ValueError, match="outside the candidate buffer"):
        propose.level_cuda(out, f_boxes, f_valid, cap, consts, *buf, 1)
    with pytest.raises(TypeError):
        propose.level_cuda({**out, "zoom": out["zoom"].double()}, f_boxes, f_valid, cap,
                           consts, *buf, 0)
    with pytest.raises(ValueError, match="sorts at most"):
        propose.level_cuda(out, f_boxes, f_valid, slk.MAX_KEYS + 1, consts, *buf, 0)


@pytest.mark.parametrize("r,next_cap,width", [
    (8, 32, 64), (32, 64, 256), (64, 64, 512), (128, 128, 1024), (8, 64, 64), (8, 65, 128),
    (1, 1, 8), (819, 819, 4096), (3276, 128, 16384)])
def test_sort_width(r, next_cap, width):
    assert slk.sort_width(r, next_cap) == width


def test_sort_width_refuses_above_the_kernel():
    with pytest.raises(ValueError, match="sorts at most 16384 keys"):
        slk.sort_width(3277, 128)
    with pytest.raises(ValueError, match="sorts at most"):
        slk.sort_width(8, 16385)


def test_wrapper_refuses_cpu_tensors():
    out, f_boxes, f_valid, cap, consts = level_case("random", 8, 0, "cpu")
    buf = (torch.zeros((8 * K, 4)), torch.zeros(8 * K))
    with pytest.raises(ValueError, match="CUDA tensors"):
        propose.level_cuda(out, f_boxes, f_valid, cap, consts, *buf, 0)
