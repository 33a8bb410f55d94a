"""Profiling helpers (counterpart of ``aznet_tpu/utils/profiling.py``): the
program's spans, a ``torch.profiler`` Chrome trace, a block timer that
synchronises the card before it reads the clock, and per-device memory
statistics.

Spans. The entries of ``api`` and the search mark where their time goes
with :func:`span`: one root a call (``propose``, ``detect``, ``fused_detect``,
``im_propose``, ``im_detect``) and under it ``upload``, ``preprocess``,
``trunk``, ``search`` (``search.level``, ``search.sync``, ``search.select``),
``heads`` and ``download``. They are recorded exactly while a
``torch.profiler`` session runs (any activities), on the host's
``time.perf_counter_ns`` clock, into memory (:func:`spans`); otherwise a span
costs one flag read. A span launches nothing on the card and reads nothing
from it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 1 << 20
MARKER_CYCLES = 200_000  # about 0.1 ms of ``torch.cuda._sleep``


class Span(NamedTuple):
    """One finished span. ``parent`` is the innermost span of the same thread
    open when it began (None for a root); ``call`` is its root's ``id``,
    shared by every span of one entry call; ``start`` and ``end`` are
    ``time.perf_counter_ns()``; ``attrs`` holds ``image``, ``level`` or
    ``rows`` where given."""

    name: str
    id: int
    parent: int | None
    call: int
    start: int
    end: int
    attrs: dict


class SpanRecorder:
    """The newest ``cap`` finished spans, in the order they ended; ``dropped``
    counts the older ones let go."""

    def __init__(self, cap: int = MAX_SPANS):
        self.cap = cap
        self.dropped = 0
        self._done = collections.deque(maxlen=cap)  # Span fields as plain tuples
        self.ids = itertools.count(1)  # each span's id, in the order they begin
        self._lock = threading.Lock()
        self._local = threading.local()

    def open_stack(self) -> list:
        """This thread's open spans, innermost last."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def record(self, fields: tuple) -> None:
        with self._lock:
            if len(self._done) == self.cap:
                self.dropped += 1
            self._done.append(fields)

    def spans(self) -> list:
        with self._lock:
            done = self._done.copy()
        return [Span._make(f) for f in done]


class _OpenSpan:
    __slots__ = ("recorder", "name", "attrs", "id", "parent", "call", "start")

    def __init__(self, recorder: SpanRecorder, name: str, attrs: dict):
        self.recorder, self.name, self.attrs = recorder, name, attrs

    def __enter__(self):
        stack = self.recorder.open_stack()
        self.id = next(self.recorder.ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, self.id
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.recorder.open_stack().pop()
        self.recorder.record((self.name, self.id, self.parent, self.call, self.start, end,
                              self.attrs))
        return False


RECORDER = SpanRecorder()
_OFF = contextlib.nullcontext()


def span(name: str, *, image: int | None = None, level: int | None = None,
         rows: int | None = None):
    """A context manager that records the block as span ``name`` while a
    ``torch.profiler`` session runs, and does nothing otherwise: then it
    reads one flag and returns one shared no-op context, with no clock read
    and no allocation (hence named attributes, not ``**attrs``)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    attrs = {}
    if image is not None:
        attrs["image"] = image
    if level is not None:
        attrs["level"] = level
    if rows is not None:
        attrs["rows"] = rows
    return _OpenSpan(RECORDER, name, attrs)


def spans() -> list:
    """The recorded spans (:class:`Span`), at most ``MAX_SPANS``, oldest
    first by their end."""
    return RECORDER.spans()


def dropped() -> int:
    """How many spans were let go past ``MAX_SPANS``."""
    return RECORDER.dropped


def _profiler_offset_ns(prof, marker_host: int):
    """The profiler's clock less ``perf_counter_ns``, from the marker
    kernel launched at host time ``marker_host``; None where the profile
    holds no such kernel."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and "spin" in e.name().lower():
            return e.start_ns() - marker_host
    return None


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the host and, where there is a card, of the card:
    ``with trace('logs/tb') as prof: step()``. Yields the profiler, whose
    ``key_averages()`` sums the events by name, and writes at exit:

    - ``<logdir>/trace.json``, the Chrome trace;
    - ``<logdir>/spans.json``, the program's spans recorded meanwhile
      (``spans``: :class:`Span` fields, times in ``perf_counter_ns``),
      ``dropped`` (how many the buffer let go meanwhile) and, on a card,
      ``profiler_offset_ns``, measured by a marker kernel at the start: a
      span's time plus it is on the profiler's clock, so
      ``(t + profiler_offset_ns - baseTimeNanoseconds) / 1000`` is
      ``trace.json``'s ``ts`` in us. Without a card it is null."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    t0, dropped0 = time.perf_counter_ns(), RECORDER.dropped
    prof.start()
    marker_host = None
    try:
        if cuda:
            torch.cuda.synchronize()
            marker_host = time.perf_counter_ns()
            torch.cuda._sleep(MARKER_CYCLES)
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        record = {
            "profiler_offset_ns": None if marker_host is None
            else _profiler_offset_ns(prof, marker_host),
            "dropped": RECORDER.dropped - dropped0,
            "spans": [s._asdict() for s in RECORDER.spans() if s.start >= t0],
        }
        with open(os.path.join(logdir, "spans.json"), "w") as f:
            json.dump(record, f)


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
