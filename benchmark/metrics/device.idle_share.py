"""The share of the traced window in which no operation ran on the card
(profiler, CUDA activity only), in %."""

from harness import readers


def read(run):
    busy = sum(b - a for a, b in run.trace["busy"]) / 1e9
    return 100.0 * (1.0 - busy / readers.traced_window_s(run))
