"""Command-line tools of the PyTorch port, one for each of ``tools/`` and
the measurement scripts ``bench.py`` / ``bench_nms.py`` (``bench*.py`` here,
timed by ``_timing.py``): each has the reference tool's options and output
lines, and ``main(argv=None) -> int`` so that it can be called in-process."""
