"""Host ms per image inside the program's ``search.sync`` spans: the host
blocked on the card where the search reads it (whether any frontier row is
valid, once a tail level), over the window's images."""

from harness import program_spans


def read(run):
    return program_spans.host_ms_per_img(run, "search.sync")
