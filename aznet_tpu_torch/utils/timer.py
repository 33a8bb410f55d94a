"""Wall-clock timer with running average.

Counterpart of ``aznet_tpu/utils/timer.py``: the tic/toc API wrapped around
the propose and detect stages. CUDA calls return before the card is done, so
synchronise (or move the result to the host) before ``toc``.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff
