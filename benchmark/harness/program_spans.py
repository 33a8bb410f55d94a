"""What the readers of the program's own spans share. The program records
its spans (``aznet_tpu_torch/utils/profiling.py``) while a ``torch.profiler``
session runs, so a ``--trace 1`` run has them and a ``--trace 0`` run does
not; they are on ``time.perf_counter_ns``, the clock ``trace.Profile`` puts
the card's operations on. They are reached only through the system the
harness built (``harness/system.py`` imports the program); a system without
them (the reference, or a program that records none) reads as ``None``."""

from __future__ import annotations

import bisect

from harness import readers


def in_window(run, name: str) -> list:
    """The program's spans called ``name`` that lie inside the traced
    window; ``[]`` where the system records none."""
    api = getattr(run.driver.system, "api", None)
    recorded = getattr(getattr(api, "profiling", None), "spans", None)
    if recorded is None:
        return []
    lo, hi = run.trace["window"]
    return [s for s in recorded() if s.name == name and lo <= s.start and s.end <= hi]


def idle_ns(busy: list, lo: int, hi: int) -> int:
    """The time in ``[lo, hi]`` that no interval of ``busy`` (sorted,
    disjoint: ``trace.busy_intervals``) covers."""
    starts = [a for a, _ in busy]
    covered = 0
    for i in range(max(bisect.bisect_right(starts, lo) - 1, 0), len(busy)):
        a, b = busy[i]
        if a >= hi:
            break
        covered += max(0, min(b, hi) - max(a, lo))
    return (hi - lo) - covered


def idle_ms_per_img(run, name: str):
    """The card's idle ms inside the spans called ``name``, per image of the
    window; ``None`` where there are none."""
    spans = in_window(run, name)
    if not spans:
        return None
    busy = run.trace["busy"]
    return sum(idle_ns(busy, s.start, s.end) for s in spans) / 1e6 / readers.images(run)


def host_ms_per_img(run, name: str):
    """Host ms inside the spans called ``name``, per image of the window;
    ``None`` where there are none."""
    spans = in_window(run, name)
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) / 1e6 / readers.images(run)
