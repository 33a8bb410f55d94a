"""Host ms per image in the search: from the trunk's exit (its hook waits
for the card there, in the traced run) to the entry's return, summed over
the calls, per image. For the one-image API it holds the download of the
proposals, which the API makes before it returns."""

from harness import readers


def read(run):
    trunk = run.trace["spans"].get("trunk", ([], []))[0]
    if len(trunk) != len(run.calls):
        return None
    return sum((c.returned - out) / 1e6 for c, (_, out) in zip(run.calls, trunk)) / readers.images(run)
