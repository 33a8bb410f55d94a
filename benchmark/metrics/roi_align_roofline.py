"""The ROI-align kernel's share of its roofline, in %: the least time of
every call in the traced window at its shapes (``roofline.roi_align_bound_s``)
over the kernel's device time. Calls on one ``[h, w, C]`` map only: a
feature pyramid's record (``trace.pyramid_shape``) has no 3-D shape, and it
reads nothing."""

from harness import readers, roofline


def read(run):
    t = readers.kernel_s(run, "roi_align")
    if t <= 0:
        return None
    stride = run.cell.conf["MODEL"]["FEAT_STRIDE"]
    pool = run.cell.conf["MODEL"]["POOL_SIZE"]
    calls = run.trace["rois"]
    if not calls or any(len(shape) != 3 or rois.dim() != 2 for shape, _, rois in calls):
        return None  # the model's head calls are not what this reader knows
    bound = sum(roofline.roi_align_bound_s(shape, size, rois, stride, pool)
                for shape, size, rois in calls)
    return 100.0 * bound / t
