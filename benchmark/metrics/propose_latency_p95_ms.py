"""The 95th percentile of every call's latency in the window, raw NumPy image
in to NumPy proposals out; a failed call counts as missing."""

from harness import readers


def read(run):
    return readers.latency_p95_ms(run)
