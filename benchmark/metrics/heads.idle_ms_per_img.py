"""The card's idle ms per image inside the program's ``heads`` spans (one an
image: the detection head's ROI align, fc6, fc7, scores and decode): the
span's host interval less the card's busy intervals clipped to it, over the
window's images."""

from harness import program_spans


def read(run):
    return program_spans.idle_ms_per_img(run, "heads")
