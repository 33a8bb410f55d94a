"""The card's idle ms per image inside the program's ``preprocess`` spans
(each raw image onto its canvas, and the blobs stacked): the span's host
interval less the card's busy intervals clipped to it, over the window's
images. For the one-image API the upload is a span of its own, outside."""

from harness import program_spans


def read(run):
    return program_spans.idle_ms_per_img(run, "preprocess")
