"""Device ms per image between CUDA events at the entry and exit of the
program's trunk module (hooks the benchmark registers)."""

from harness import readers


def read(run):
    if not readers.span_ms(run, "trunk"):
        return None
    return sum(readers.span_ms(run, "trunk")) / readers.images(run)
