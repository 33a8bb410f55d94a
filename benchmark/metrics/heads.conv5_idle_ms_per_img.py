"""The card's idle ms per image inside the program's ``heads.conv5`` spans
(one a head call of the C4 detector: conv5_x on the call's pools and the
mean over its output): the span's host interval less the card's busy
intervals clipped to it, over the window's images. Whether the host keeps
the card fed through the per-box stack. The spans lie inside the ``heads``
spans, so this is part of ``heads.idle_ms_per_img``, not a layer beside it."""

from harness import program_spans


def read(run):
    return program_spans.idle_ms_per_img(run, "heads.conv5")
