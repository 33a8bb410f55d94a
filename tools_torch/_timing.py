"""The measurement recipe of the port's benchmark tools: the counterpart of
``bench.py::scan_diff_time``.

The reference differenced two scan lengths to cancel a remote relay's
dispatch latency; the port's calls reach the card directly, so
:func:`event_time` times ``reps`` back-to-back calls with CUDA events (the
host clock with ``--cpu``) and keeps the reference's contract:

- it warms up twice;
- a set of ``trials`` trials whose max/min spread exceeds ``tol`` is retried,
  up to ``retries`` times, and then the minimum positive estimate is
  returned with ``contended=True``;
- no positive estimate at all gives ``(nan, True)``.

It returns the median seconds per call beside the trials of the set that
decided it, so that each tool reports the spread with the median.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np


class Timing(NamedTuple):
    seconds: float  # per call: the median of the trials, or see the module's docstring
    contended: bool
    trials: tuple  # per-call seconds of each trial of the deciding set


def cuda_timer(run: Callable, reps: int) -> float:
    """Seconds of ``reps`` back-to-back calls of ``run`` by CUDA events on the
    current stream."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def host_timer(run: Callable, reps: int) -> float:
    """Seconds of ``reps`` calls of ``run`` by the host clock (the CPU runs)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    return time.perf_counter() - t0


def timer_for(device) -> Callable:
    """:func:`cuda_timer` for a CUDA device, :func:`host_timer` for the CPU."""
    return host_timer if str(device) == "cpu" else cuda_timer


def event_time(run: Callable, reps: int, trials: int = 3, retries: int = 2, tol: float = 2.0,
               timer: Callable = cuda_timer) -> Timing:
    """Per-call seconds of ``run`` (see the module's docstring);
    ``timer(run, reps)`` gives the seconds of one trial of ``reps`` calls."""
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    for _ in range(2):
        run()
    contended = False
    dts: list = []
    for _ in range(retries + 1):
        dts = [timer(run, reps) / reps for _ in range(trials)]
        if min(dts) > 0 and max(dts) <= tol * min(dts):
            return Timing(float(np.median(dts)), contended, tuple(dts))
        contended = True
    good = [d for d in dts if d > 0]
    return Timing(float(min(good)) if good else float("nan"), True, tuple(dts))
