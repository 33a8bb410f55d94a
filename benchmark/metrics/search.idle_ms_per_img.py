"""The card's idle ms per image inside the program's ``search`` spans (one
an image: the level loop, the candidate cap and NMS, the boxes back to the
original scale): the span's host interval less the card's busy intervals
clipped to it, over the window's images."""

from harness import program_spans


def read(run):
    return program_spans.idle_ms_per_img(run, "search")
