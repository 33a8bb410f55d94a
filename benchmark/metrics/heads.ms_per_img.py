"""Device ms per image between CUDA events at the entry and exit of the
program's head module (fc6, fc7 and the output dot)."""

from harness import readers


def read(run):
    if not readers.span_ms(run, "head"):
        return None
    return sum(readers.span_ms(run, "head")) / readers.images(run)
