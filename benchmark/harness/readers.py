"""What the metric readers under ``metrics/`` share."""

from __future__ import annotations

import math

from harness import roofline, trace as tr


def images(run) -> int:
    return sum(c.images for c in run.calls if c.ok)


def window_s(run) -> float:
    """Host seconds from the first call's start to the last call's end."""
    return (run.calls[-1].end - run.calls[0].start) / 1e9


def images_per_s(run) -> float:
    """Images whose results reached the host, over all the window's time."""
    return images(run) / window_s(run)


def latency_p95_ms(run):
    """The 95th percentile (nearest rank) of every call's latency; a failed
    call counts as missing."""
    lat = sorted((c.end - c.start) / 1e6 if c.ok else math.inf for c in run.calls)
    v = lat[math.ceil(0.95 * len(lat)) - 1]
    return v if math.isfinite(v) else None


def traced_window_s(run) -> float:
    lo, hi = run.trace["window"]
    return (hi - lo) / 1e9


def kernel_s(run, kernel: str) -> float:
    """Device seconds of the port's ``kernel`` (``roofline.KERNELS``) in the
    traced window."""
    pat = roofline.KERNELS[kernel]
    return sum(b - a for n, a, b in run.trace["events"] if pat.search(n)) / 1e9


def kernel_count(run) -> int:
    return sum(1 for n, _, _ in run.trace["events"] if not tr.is_copy(n))


def span_ms(run, module: str) -> list:
    return run.trace["spans"].get(module, ([], []))[1]
