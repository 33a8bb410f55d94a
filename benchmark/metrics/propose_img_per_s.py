"""Images whose proposals (boxes, scores, valid flags) reached the host,
over the window's host seconds; closed loop, one client."""

from harness import readers


def read(run):
    return readers.images_per_s(run)
