"""One run of one cell: set-up, the measured window (or, with ``trace``, the
traced calls), the correctness check, the metrics, the result line.

A driver (``drivers/<driver>.py``, named by the traffic mix) owns the inputs
and the entry it calls; this module owns the clock, the sample, the trace
and the order of the steps: the program's memory peak is read and the
program freed before the reference runs."""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
import traceback

import numpy as np
import torch

from harness import check, inputs, spec, trace as tr
from harness.system import PortSystem

MAX_FAILS_IN_A_ROW = 3
BANNED = ("jax", "jaxlib", "flax", "aznet_tpu")


@dataclasses.dataclass
class Call:
    start: int  # perf_counter_ns
    returned: int  # the entry returned (before the results were copied to the host)
    end: int  # the results are on the host
    images: int
    ok: bool


class Sample:
    """A uniform sample of ``k`` of the images offered (reservoir), drawn
    from the seed; ``make`` builds an image's entry only when it is kept."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.slots = k, 0, {}
        self.rng = np.random.default_rng(inputs.stream_seed(seed, "sample"))

    def offer(self, make) -> None:
        t = self.seen
        self.seen += 1
        slot = t if t < self.k else int(self.rng.integers(0, t + 1))
        if slot < self.k:
            self.slots[slot] = make()

    def items(self) -> list:
        return [self.slots[i] for i in sorted(self.slots)]


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: spec.Cell
    calls: list
    setup_s: float
    driver: object
    trace: dict | None = None


def run_calls(driver, sample: Sample, seconds: float = None, count: int = None) -> list:
    """Closed loop: each call after the last one's results reached the host,
    for ``seconds`` (the last call started inside the window counts whole)
    or for ``count`` calls. Python's cyclic garbage collector is off in the
    window (what set-up made is frozen first), so that no collection of
    set-up's objects lands in a call."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        return _loop(driver, sample, seconds, count)
    finally:
        gc.enable()
        gc.unfreeze()


def _loop(driver, sample: Sample, seconds, count) -> list:
    calls, fails, k = [], 0, 0
    t_end = time.perf_counter_ns() + int((seconds or 0) * 1e9)
    while True:
        t0 = time.perf_counter_ns()
        try:
            out = driver.call(k)
            ok = True
        except Exception:  # a failed call counts as missing; the run goes on
            traceback.print_exc(file=sys.stderr)
            out, ok = None, False
        t1 = time.perf_counter_ns()
        calls.append(Call(t0, driver.returned if ok else t1, t1, driver.images_per_call, ok))
        if ok:
            driver.keep(k, out, sample)
        fails = 0 if ok else fails + 1
        k += 1
        if fails >= MAX_FAILS_IN_A_ROW or (t1 >= t_end if count is None else k >= count):
            return calls


def traced_calls(driver, sample: Sample) -> tuple:
    """The traffic's ``trace_calls`` calls under the profiler and the span
    hooks: ``(calls, trace dict)``."""
    system = driver.system
    spans = tr.Spans(driver.span_modules(), sync_out=("trunk",))
    rois = tr.RoiLog(system.model)
    before = system.launches()
    try:
        with tr.Profile() as prof:
            calls = run_calls(driver, sample, count=driver.traffic["trace_calls"])
    finally:
        spans.remove()
        rois.remove()
    after = system.launches()
    lo, hi = calls[0].start, calls[-1].end
    busy = tr.busy_intervals(prof.events, lo, hi)
    data = {
        "events": [e for e in prof.events if lo <= e[1] and e[2] <= hi],
        "window": (lo, hi),
        "busy": busy,
        "gaps": tr.idle_gaps(busy, lo, hi),
        "launches": {k: after[k] - before.get(k, 0) for k in after},
        "spans": {name: (spans.host(name), spans.device_ms(name)) for name in spans.calls},
        "rois": rois.calls,
    }
    cross_check(data)
    return calls, data


COUNTED = {"roi_align": "roi_align", "nms": "nms_scan", "conv1": "conv1"}  # counter: pattern


def cross_check(data: dict) -> None:
    """The profiler's count of each of the port's kernels against the
    port's own launch counter: a profiler that lost events shows here."""
    from harness import roofline

    for counter, kernel in COUNTED.items():
        seen = sum(1 for n, _, _ in data["events"] if roofline.KERNELS[kernel].search(n))
        launched = data["launches"].get(counter, 0)
        if seen != launched:
            print(f"profiler saw {seen} {kernel} kernels, the port counted {launched} launches",
                  file=sys.stderr)


def breakdown(run: Run) -> dict:
    """The device operations that took most time, by name, and the idle
    time by what the host was doing then (the harness's own spans)."""
    t = run.trace
    by_op = {}
    for name, a, b in t["events"]:
        key = name if len(name) <= 160 else name[:157] + "..."
        by_op[key] = by_op.get(key, 0.0) + (b - a) / 1e9
    labels = host_spans(run)
    idle = {}
    for a, b in t["gaps"]:
        mid = (a + b) // 2
        label = next((lab for lo, hi, lab in labels if lo <= mid < hi), "harness")
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(idle)}


def host_spans(run: Run) -> list:
    """``[(start, end, label)]``: each call's preprocess (to the trunk's
    entry), trunk, search or heads (to the entry's return) and download."""
    trunk = run.trace["spans"].get("trunk", ([], []))[0]
    middle = run.driver.middle_span
    out = []
    for i, c in enumerate(run.calls):
        t_in, t_out = trunk[i] if i < len(trunk) else (c.start, c.start)
        out += [(c.start, t_in, "preprocess"), (t_in, t_out, "trunk"),
                (t_out, c.returned, middle), (c.returned, c.end, "download")]
    return out


def jax_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def _finite(v):
    return v if math.isfinite(v) else str(v)


def measure(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
            system_cls=PortSystem) -> tuple:
    """Set-up, the window (or the traced calls) and the metrics: ``(result
    line less ``correct`` and the checks, driver, sample, calls)``; the
    program is freed."""
    driver = spec.driver_class(cell)(cell, seed, device, system_cls)
    driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    print("set-up " + " ".join(f"{k} {v:.3f}" for k, v in driver.setup_parts.items())
          + f" total {setup_s:.3f}", file=sys.stderr)
    sample = Sample(cell.traffic["check_images"], seed)
    trace = None
    if traced:
        calls, trace = traced_calls(driver, sample)
    else:
        calls = run_calls(driver, sample, seconds=seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = Run(cell, calls, setup_s, driver, trace)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(cell.bench_dir, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        lo, hi = trace["window"]
        device_info["busy_s"] = sum(b - a for a, b in trace["busy"]) / 1e9
        device_info["window_s"] = (hi - lo) / 1e9
    result = {"attempted": sum(c.images for c in calls),
              "failed": sum(c.images for c in calls if not c.ok),
              "metrics": metrics, "device": device_info}
    if traced:
        result["breakdown"] = breakdown(run)
    driver.release()
    return result, driver, sample, calls


def judge(cell: spec.Cell, seed: int, device, driver, sample: Sample) -> dict:
    """The compared numbers of the sampled images, by the reference on
    weights drawn again from the seed."""
    weights = inputs.make_weights(cell.conf["MODEL"], driver.kind, seed, device)
    return driver.check(check.Reference(cell.conf, driver.kind, weights, device), sample)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, system_cls=PortSystem) -> dict:
    """One run; returns the result line as a dict."""
    measured, driver, sample, _ = measure(cell, seed, seconds, traced, device, t_start,
                                          system_cls)
    numbers = judge(cell, seed, device, driver, sample)
    parts = {k: v for k, v in numbers.items() if k not in cell.limits}  # what makes up a number
    if parts:
        print("check parts " + " ".join(f"{k} {v}" for k, v in parts.items()), file=sys.stderr)
    correct, rows = check.verdict({k: v for k, v in numbers.items() if k not in parts},
                                  cell.limits)
    result = {"correct": correct and measured["failed"] == 0, **measured}
    result["checks"] = {name: {"value": _finite(v), "limit": lim} for name, v, lim in rows}
    return result
