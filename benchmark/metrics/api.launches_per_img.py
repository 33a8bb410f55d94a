"""Operations the card ran in the traced window (kernels, not copies), per
image: what the host dispatched for each image through the API."""

from harness import readers


def read(run):
    return readers.kernel_count(run) / readers.images(run)
