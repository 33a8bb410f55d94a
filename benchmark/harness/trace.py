"""What a ``--trace 1`` run reads, beside its calls' host spans:

- ``Profile``: ``torch.profiler`` with CUDA activity only (no host operator
  events, so the host's launch rate is the untraced one) over the traced
  calls; the device operations' names and intervals, put on the host's clock
  by a marker kernel launched at a known host time;
- ``Spans``: CUDA events and host times at the entry and exit of the
  program's trunk and head modules, from forward pre-hooks and hooks that
  the benchmark registers (the program itself has no spans);
- ``RoiLog``: the shapes of each call of the model's ``roi_forward`` (the
  feature map, or a pyramid's levels, and the rois), for the ROI-align
  kernel's roofline.

Only the intervals are kept; no trace file is written."""

from __future__ import annotations

import time

import torch

MARKER_CYCLES = 200_000  # about 0.1 ms of ``torch.cuda._sleep``


class Spans:
    """Per call of each hooked module: ``(host_in, host_out, event_in,
    event_out)``. For the modules in ``sync_out`` the exit hook waits for the
    card first, so that the host's time after it is the host's alone."""

    def __init__(self, modules: dict, sync_out=()):
        self.calls = {name: [] for name in modules}
        self.handles = []
        for name, mod in modules.items():
            rec = self.calls[name]

            def pre(_mod, _args, rec=rec):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                rec.append([time.perf_counter_ns(), None, ev, None])

            def post(_mod, _args, _out, rec=rec, sync=name in sync_out):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                if sync:
                    ev.synchronize()
                rec[-1][1], rec[-1][3] = time.perf_counter_ns(), ev

            self.handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []

    def device_ms(self, name: str) -> list:
        """Each call's device time in ms, event to event (synchronises)."""
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for _, _, a, b in self.calls[name]]

    def host(self, name: str) -> list:
        return [(a, b) for a, b, _, _ in self.calls[name]]


def pyramid_shape(level_shapes) -> dict:
    """What ``RoiLog`` records of a pyramid in place of a map's shape:
    ``{"levels": ((h, w, C), ...)}``, a form that no reader of a single
    map's ``(h, w, C)`` takes for one (its ``len`` is 1)."""
    return {"levels": tuple(level_shapes)}


def is_pyramid_shape(shape) -> bool:
    return isinstance(shape, dict)


class RoiLog:
    """``(feature map shape, element size, rois)`` of each call of
    ``owner.roi_forward(feat, rois, ...)`` until :meth:`remove`; where
    ``feat`` is a sequence of level maps, the shape is ``pyramid_shape`` of
    theirs and the element size the first level's."""

    def __init__(self, owner):
        self.owner, self.calls = owner, []
        fn, calls = owner.roi_forward, self.calls

        def roi_forward(feat, rois, *args, **kwargs):
            if isinstance(feat, torch.Tensor):
                calls.append((tuple(feat.shape), feat.element_size(), rois))
            else:
                calls.append((pyramid_shape(tuple(level.shape) for level in feat),
                              feat[0].element_size(), rois))
            return fn(feat, rois, *args, **kwargs)

        owner.roi_forward = roi_forward

    def remove(self) -> None:
        self.owner.__dict__.pop("roi_forward", None)


def _device_events(prof) -> list:
    """``[(name, start_ns, end_ns)]`` of the card's operations, in the
    profiler's clock."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


class Profile:
    """The card's operations over a window, on the host's
    ``perf_counter_ns`` clock."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.events = []
        self.marker_host = None

    def __enter__(self):
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.marker_host = time.perf_counter_ns()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        events = sorted(_device_events(self.prof), key=lambda e: e[1])
        if not events:
            return False
        marker = next((e for e in events if "spin" in e[0].lower()), events[0])
        shift = self.marker_host - marker[1]
        self.events = [(n, a + shift, b + shift) for n, a, b in events if (n, a, b) != marker]
        return False


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def busy_intervals(events: list, lo: int, hi: int) -> list:
    """The union of the operations' intervals clipped to ``[lo, hi]``."""
    merged = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def idle_gaps(busy: list, lo: int, hi: int) -> list:
    """``[(start, end)]`` of the device's idle time in ``[lo, hi]``."""
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps
