"""What the drivers under ``drivers/`` share: the cell, the seed, the system
under test, the sample kept for the check."""

from __future__ import annotations

import gc
import time

import torch

from harness import check, inputs


class Driver:
    """A traffic driver. A subclass sets ``kind`` (``'az'`` or ``'frcnn'``)
    and ``middle_span`` (what the host does between the trunk and the
    entry's return), and fills ``setup``, ``call`` and ``numbers``."""

    kind = "az"
    middle_span = "search"

    def __init__(self, cell, seed: int, device, system_cls):
        self.cell, self.seed, self.device, self.system_cls = cell, seed, device, system_cls
        self.conf, self.traffic = cell.conf, cell.traffic
        self.images_per_call = int(self.traffic["batch"])
        self.returned = 0  # perf_counter_ns when the entry returned, set by ``call``
        self.system = None

    def build_system(self) -> None:
        t0 = time.perf_counter()
        weights = inputs.make_weights(self.conf["MODEL"], self.kind, self.seed, self.device)
        t1 = time.perf_counter()
        self.system = self.system_cls(self.conf, self.kind, weights, self.device)
        self.setup_parts = {"weights_s": t1 - t0, "build_s": time.perf_counter() - t1}

    def warm_up(self, calls: int = 2) -> None:
        """Every shape of the cell's calls, twice: the first builds or loads
        the kernels."""
        t0 = time.perf_counter()
        for k in range(calls):
            self.call(k)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_parts["warm_up_s"] = time.perf_counter() - t0

    def span_modules(self) -> dict:
        return {"trunk": self.system.trunk}

    def keep(self, k: int, out, sample) -> None:
        """After call ``k``: offer each of its images to the sample with its
        results."""
        for i in range(self.images_per_call):
            sample.offer(lambda i=i: (k, i, self.result_of(out, i)))

    @staticmethod
    def result_of(out, i: int):
        """Image ``i``'s part of a call's results."""
        return tuple(t[i] for t in out)

    def release(self) -> None:
        """Free the program before the reference runs."""
        self.system = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, ref: check.Reference, sample) -> dict:
        """The worst of each number over the sampled images."""
        worst = {}
        for k, i, result in sample.items():
            for name, v in self.numbers(ref, k, i, result).items():
                worst[name] = check.worst(worst.get(name, 0.0), v)
        return worst

    def stamp(self) -> None:
        self.returned = time.perf_counter_ns()
