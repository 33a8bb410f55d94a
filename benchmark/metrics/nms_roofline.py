"""The NMS kernels' (sort, mask, scan) share of their roofline, in %: one
stream of the capped candidates an image, at the least time of
``roofline.nms_bound_s``, over the kernels' device time."""

from harness import readers, roofline


def read(run):
    t = readers.kernel_s(run, "nms")
    if t <= 0:
        return None
    conf = run.cell.conf
    n = roofline.candidates(conf["SEAR"], conf["MODEL"]["NUM_TEMPLATES"])
    return 100.0 * readers.images(run) * roofline.nms_bound_s(n) / t
