"""Profiling helpers (counterpart of ``aznet_tpu/utils/profiling.py``): a
``torch.profiler`` Chrome trace, a block timer that synchronises the card
before it reads the clock, and per-device memory statistics.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the host and, where there is a card, of the card:
    ``with trace('logs/tb') as prof: step()``. Writes
    ``<logdir>/trace.json`` (Chrome trace format) at exit and yields the
    profiler, whose ``key_averages()`` sums the events by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _synchronize(tree) -> None:
    """Wait for the CUDA tensors in ``tree`` (nested dicts, lists and tuples),
    or for the current card when ``tree`` is None."""
    if tree is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    devices = set()

    def walk(node):
        if isinstance(node, torch.Tensor):
            if node.is_cuda:
                devices.add(node.device)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(tree)
    for d in devices:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def block_timer(name: str, tree=None):
    """Wall-time a block: ``with block_timer('step', out) as t: ...``. At exit
    it waits for the CUDA tensors in ``tree`` (or the current card), sets
    ``t['seconds']`` and prints ``[timer] name: ... ms``."""
    t0 = time.perf_counter()
    out = {}
    try:
        yield out
    finally:
        _synchronize(tree)
        out["seconds"] = time.perf_counter() - t0
        print(f"[timer] {name}: {out['seconds'] * 1000:.2f} ms", flush=True)


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` per visible card, keyed ``cuda:<i>``; ``{}``
    without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
