"""The table of the port's hand-written kernels (``aznet_tpu_torch/kernels.py``)
and the launch counters (``ops/cuda/__init__.py``), on the CPU: every
counter has a row and every row resolves; an entry is looked up when it is
called; the counters round-trip; a call recorded through an entry that is
its own plain version replays bit for bit, and a recorded output one ulp
off fails. Imports no JAX."""

import importlib
import pkgutil

import numpy as np
import pytest
import torch

from _search_level_cases import K, SEARCH_CONFIGS, level_case
from aznet_tpu_torch import kernels
from aznet_tpu_torch.ops import conv1_fused as tconv1
from aznet_tpu_torch.ops import conv_int8 as tconv
from aznet_tpu_torch.ops import cuda as tcuda
from aznet_tpu_torch.search import propose

SCFG = SEARCH_CONFIGS["vgg16"][0]


def _boxes(rng, n, extent=200.0):
    xy = rng.uniform(0, extent, (n, 2))
    wh = rng.uniform(2, 60, (n, 2))
    return torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(np.float32))


def kernel_args(name: str, seed: int = 0) -> tuple:
    """Small CPU arguments of each row's card entry."""
    rng = np.random.RandomState(seed)
    g = torch.Generator().manual_seed(seed)
    if name == "nms":
        scores = torch.from_numpy(rng.rand(2, 24).astype(np.float32))
        valid = torch.from_numpy(rng.rand(2, 24) < 0.9)
        return torch.stack([_boxes(rng, 24), _boxes(rng, 24)]), scores, 0.5, valid, 1.0
    if name == "roi_align":
        feat = torch.randn(10, 12, 16, generator=g).to(torch.bfloat16)
        return feat, _boxes(rng, 5, 150.0), 1 / 16.0, 3, False
    if name in ("conv1", "conv1_f32"):
        dtype = torch.float32 if name == "conv1_f32" else torch.bfloat16
        layout = tconv1.kernel_layout_f32 if name == "conv1_f32" else tconv1.kernel_layout
        w12 = 0.1 * torch.randn(16, 8, 3, 3, generator=g)
        y = torch.randn(1, 6, 8, 8, generator=g).relu().to(dtype)
        return y, layout(w12), torch.randn(16, generator=g)
    if name in ("chain", "strip"):
        layer = tconv.Int8Conv.from_float(0.05 * torch.randn(32, 16, 3, 3, generator=g),
                                          torch.randn(32, generator=g))
        x = torch.randint(-127, 128, (1, 6, 8, 16), generator=g, dtype=torch.int8)
        s_out = 0.25 if name == "chain" else None
        return x, 0.05, layer.w_k, layer.s_w, layer.bias, s_out
    if name == "iou":
        return _boxes(rng, 7), _boxes(rng, 5), 1.0
    if name == "search_seed":
        total = propose.candidate_starts(SCFG, K)[1]
        return (torch.tensor(375.0), torch.tensor(500.0)), SCFG, 1.0, 8, total, \
            torch.device("cpu")
    if name == "search_level":
        out, f_boxes, f_valid, next_cap, consts = level_case("random", 8, seed, "cpu")
        total = 8 * K + 24
        return (out, f_boxes, f_valid, next_cap, consts, torch.zeros(total, 4),
                torch.full((total,), propose.NEG_INF), 16)
    if name == "search_select":
        return _boxes(rng, 96, 500.0), torch.from_numpy(rng.rand(96).astype(np.float32)), \
            SCFG, 1.0
    raise KeyError(name)


@pytest.fixture
def plain_entries(monkeypatch):
    """Every row's card entry replaced by its plain version."""
    for row in kernels.KERNELS.values():
        monkeypatch.setattr(row.owner, row.attr, row.plain)


def test_every_counter_has_a_row_and_every_row_resolves():
    kept = set()
    for info in pkgutil.iter_modules(tcuda.__path__):
        mod = importlib.import_module(f"{tcuda.__name__}.{info.name}")
        kept |= {(mod, a) for a in vars(mod) if a.startswith("LAUNCHES")}
    assert kept == set(tcuda.COUNTERS.values())
    assert {row.counter for row in kernels.KERNELS.values()} == set(tcuda.COUNTERS)
    assert set(tcuda.launch_counts()) == set(tcuda.COUNTERS)
    for row in kernels.KERNELS.values():
        assert callable(row.card) and callable(row.plain)
        assert row.card is getattr(row.owner, row.attr)
        assert row.within is None or row.within in kernels.KERNELS


def test_entries_are_looked_up_when_called(monkeypatch):
    calls = []

    def planted(*args):
        calls.append(len(args))
        return propose.level_plain(*args)

    monkeypatch.setattr(propose, "level_cuda", planted)
    row = kernels.KERNELS["search_level"]
    assert row.card is planted
    args = kernel_args("search_level")
    with kernels.recording(["search_level"]) as records:
        assert propose.level_cuda is not planted
        row.card(*args)
    assert propose.level_cuda is planted and calls == [8] and len(records) == 1


def test_launch_counts_round_trip():
    saved = tcuda.launch_counts()
    try:
        want = {name: i + 3 for i, name in enumerate(tcuda.COUNTERS)}
        tcuda.set_launch_counts(want)
        assert tcuda.launch_counts() == want
        for name, (module, attr) in tcuda.COUNTERS.items():
            assert getattr(module, attr) == want[name]
        tcuda.set_launch_counts(tcuda.launch_counts())
        assert tcuda.launch_counts() == want
        tcuda.set_launch_counts({"iou": 0})
        assert tcuda.launch_counts() == {**want, "iou": 0}
        tcuda.set_launch_counts()
        assert set(tcuda.launch_counts().values()) == {0}
    finally:
        tcuda.set_launch_counts(saved)


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_record_and_replay_bit_for_bit(plain_entries, name):
    row = kernels.KERNELS[name]
    args = kernel_args(name)
    with kernels.recording() as records:
        row.card(*args)
        row.card(*kernel_args(name, seed=1))
    assert [r.name for r in records] == [name, name]
    held = kernels.held(records)
    assert list(held) == [name]
    assert held[name]["ok"] and held[name]["n"] == 2
    assert held[name]["err"] == 0.0 and held[name]["differ"] == 0.0
    if row.writes:  # the level wrote its rows of the candidate buffers, and only those
        before, written = records[0].args, records[0].written
        assert not torch.equal(written[1], before[6])
        assert torch.equal(written[0][:16], before[5][:16])


def _one_ulp(t: torch.Tensor) -> None:
    """Moves the first element of ``t`` by one ulp (one code, or a flip), in place."""
    flat = t.view(-1)
    if t.dtype == torch.bool:
        flat[0] = ~flat[0]
    elif t.is_floating_point():
        flat[0] = torch.nextafter(flat[:1], torch.tensor([float("inf")], dtype=t.dtype))[0]
    else:
        flat[0] = flat[0] + 1 if flat[0] < 127 else flat[0] - 1


@pytest.mark.parametrize("name", sorted(n for n, row in kernels.KERNELS.items()
                                        if row.rule is kernels.equal_bits))
def test_replay_fails_one_ulp_off(plain_entries, name):
    row = kernels.KERNELS[name]
    with kernels.recording([name]) as records:
        row.card(*kernel_args(name))
    rec = records[0]
    _one_ulp((rec.written or kernels._tensors(rec.out))[-1])
    held = kernels.held(records)[name]
    assert not held["ok"] and 0.0 < held["differ"] < 1.0


@pytest.mark.parametrize("name", ["conv1", "conv1_f32"])
def test_conv1_rows_hold_within_one_bf16_ulp(plain_entries, name):
    row = kernels.KERNELS[name]
    with kernels.recording([name]) as records:
        row.card(*kernel_args(name))
    out = records[0].out
    i = int(out.float().abs().argmax())
    flat = out.view(-1)
    flat[i] = torch.nextafter(flat[i:i + 1], torch.tensor([float("inf")], dtype=out.dtype))[0]
    held = kernels.held(records)[name]
    assert held["ok"] and held["err"] > 0.0
    flat[i] = flat[i] * 1.02
    assert not kernels.held(records)[name]["ok"]


def test_first_only_keeps_each_entrys_first_call_and_the_first_searchs_levels(plain_entries):
    with kernels.recording(first_only=True) as records:
        for seed in range(2):
            propose.seed_cuda(*kernel_args("search_seed"))
            for lvl in range(3):
                propose.level_cuda(*kernel_args("search_level", seed=lvl))
            propose.select_cuda(*kernel_args("search_select", seed=seed))
        tcuda.nms_kernel.nms_cuda_batched(*kernel_args("nms"))
    assert [r.name for r in records] == ["search_seed"] + ["search_level"] * 3 + [
        "search_select", "nms"]
    assert all(v["ok"] for v in kernels.held(records).values())
