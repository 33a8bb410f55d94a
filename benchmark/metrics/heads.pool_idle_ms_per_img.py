"""The card's idle ms per image inside the program's ``heads.pool`` spans
(one an image of a feature pyramid's detect call: each box routed to its
level and pooled there, one kernel launch): the span's host interval less
the card's busy intervals clipped to it, over the window's images. Whether
the host keeps the card fed through the pooling. The spans lie inside the
``heads`` spans, so this is part of ``heads.idle_ms_per_img``, not a layer
beside it."""

from harness import program_spans


def read(run):
    return program_spans.idle_ms_per_img(run, "heads.pool")
