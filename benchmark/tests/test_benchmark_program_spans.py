"""The readers of the program's own spans (``harness/program_spans.py`` and
the ``*.idle_ms_per_img`` and ``search.sync_ms_per_img`` metrics): known idle
and host ms from made-up spans, busy intervals and windows; nothing from a
system without spans or from spans outside the window; and the traced line
of each cell at a CPU test's size carries the ones its ``per_layer``
entries in ``BENCHMARK.json`` give it."""

import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import BENCH, tiny_cell
from harness import program_spans, runner, spec, trace as tr
from harness.system import ReferenceSystem

MS = 1_000_000  # ns
CELLS = [w["name"] for w in spec.load_bench()["workloads"]]


def span(name, start_ms, end_ms):
    return SimpleNamespace(name=name, start=int(start_ms * MS), end=int(end_ms * MS))


def fake_run(spans, busy_ms, window_ms=(0, 100), images=(4,), system=None):
    if system is None:
        system = SimpleNamespace(api=SimpleNamespace(profiling=SimpleNamespace(
            spans=lambda: list(spans))))
    calls = [runner.Call(0, 0, 0, n, True) for n in images]
    trace = {"window": tuple(int(t * MS) for t in window_ms),
             "busy": [[int(a * MS), int(b * MS)] for a, b in busy_ms]}
    return SimpleNamespace(driver=SimpleNamespace(system=system), trace=trace, calls=calls)


def read(metric, run):
    return spec.reader(BENCH, metric)(run)


@pytest.mark.parametrize("lo,hi,want", [
    (0, 10, 5), (2, 3, 0), (3, 7, 2), (9, 30, 16), (20, 22, 2), (14, 16, 2)])
def test_idle_ns_against_a_sum_by_hand(lo, hi, want):
    busy = [[1, 3], [5, 8], [12, 14], [16, 19]]
    assert program_spans.idle_ns(busy, lo, hi) == want


def test_readers_give_known_idle_and_sync_ms():
    spans = [span("preprocess", 0, 10), span("trunk", 10, 20),
             span("search", 20, 50), span("search.sync", 22, 23.5),
             span("search.sync", 30, 31), span("search", 50, 80),
             span("search.sync", 60, 62.5), span("heads", 80, 90)]
    busy = [(2, 4), (10, 21), (25, 35), (40, 45), (55, 75), (81, 82), (85, 86)]
    run = fake_run(spans, busy, images=(2, 2))
    # preprocess 10 - 2; search (30 - 1 - 10 - 5) + (30 - 20); heads 10 - 2; 4 images
    assert read("preprocess.idle_ms_per_img.batch", run) == pytest.approx(8 / 4)
    assert read("search.idle_ms_per_img.b1", run) == pytest.approx((14 + 10) / 4)
    assert read("heads.idle_ms_per_img.detect", run) == pytest.approx(8 / 4)
    assert read("search.sync_ms_per_img.batch", run) == pytest.approx((1.5 + 1 + 2.5) / 4)


def test_nothing_from_a_system_without_spans():
    run = fake_run([span("search", 0, 10)], [(0, 1)], system=object.__new__(ReferenceSystem))
    for metric in ("preprocess.idle_ms_per_img.batch", "search.idle_ms_per_img.batch",
                   "heads.idle_ms_per_img.detect", "search.sync_ms_per_img.batch"):
        assert read(metric, run) is None
    # a program without ``profiling.spans`` (one that records none)
    bare = SimpleNamespace(api=SimpleNamespace(profiling=SimpleNamespace()))
    assert read("search.idle_ms_per_img.batch", fake_run([], [], system=bare)) is None


def test_nothing_from_spans_outside_the_window():
    spans = [span("search", -5, 20), span("search", 90, 101), span("search.sync", 200, 201),
             span("heads", 150, 160)]
    run = fake_run(spans, [(0, 100)])
    for metric in ("search.idle_ms_per_img.batch", "search.sync_ms_per_img.batch",
                   "heads.idle_ms_per_img.detect"):
        assert read(metric, run) is None
    run = fake_run(spans + [span("search", 30, 40)], [(30, 35)])
    assert read("search.idle_ms_per_img.batch", run) == pytest.approx(5 / 4)


class _CpuProfile:
    """``trace.Profile`` without a card: a CPU-only ``torch.profiler``
    session (so the program records its spans) and no device operations."""

    def __init__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.events = []

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False


class _NoSpans:
    def __init__(self, modules, sync_out=()):
        self.calls = {name: [] for name in modules}

    def remove(self):
        pass

    def device_ms(self, name):
        return []

    def host(self, name):
        return []


def span_metrics(name: str) -> list:
    """The per-layer metrics of the cell whose readers read the program's
    spans (they import ``harness.program_spans``)."""
    cell = spec.load_cell(name)
    return [m["name"] for m in cell.per_layer
            if program_spans in spec.reader(cell.bench_dir, m["name"]).__globals__.values()]


CELL_METRICS = {name: span_metrics(name) for name in CELLS}


@pytest.mark.parametrize("name", [name for name in CELLS if CELL_METRICS[name]])
def test_traced_line_of_a_tiny_cell_reads_the_program_spans(name, monkeypatch):
    monkeypatch.setattr(tr, "Profile", _CpuProfile)
    monkeypatch.setattr(tr, "Spans", _NoSpans)
    cell = tiny_cell(name)
    r = runner.run_cell(cell, 2 ** 31 + 9, 0.0, True, torch.device("cpu"),
                        time.perf_counter())
    assert r["correct"], r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items() if k in CELL_METRICS[name]}
    assert set(got) == set(CELL_METRICS[name]), r["metrics"]
    assert all(v > 0 and r["metrics"][k]["unit"] == "ms/img" for k, v in got.items())
    # No device operations here: the card is idle all the window, and the
    # layers' idle time fits in it.
    idle = sum(v for k, v in got.items() if ".idle_ms_per_img." in k)
    assert idle <= r["device"]["window_s"] * 1e3 / r["attempted"]
