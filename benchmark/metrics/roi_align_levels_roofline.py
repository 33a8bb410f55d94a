"""The pyramid ROI-align kernel's share of its roofline, in %: the least
time of every ``roi_forward`` call in the traced window on a feature pyramid
(a ``trace.pyramid_shape`` record), summed over the call's levels
(``roofline.roi_align_bound_s`` at each level's map shape, its stride in the
network's ``STRIDES`` and the rois its ``levels_of`` sends there), over the
device time of the kernel's own name. Reads nothing where a call is on one
map or the network has no ``levels_of``."""

import re

from harness import roofline, trace as tr
from reference import nets

KERNEL = re.compile(r"::roi_align_levels_kernel[<(]")


def read(run):
    net = nets.network(run.cell.conf["MODEL"])
    calls = run.trace["rois"]
    if not calls or not hasattr(net, "levels_of") or not all(
            tr.is_pyramid_shape(shape) and rois.dim() == 2 for shape, _, rois in calls):
        return None
    t = sum(b - a for n, a, b in run.trace["events"] if KERNEL.search(n)) / 1e9
    if t <= 0:
        return None
    pool = run.cell.conf["MODEL"]["POOL_SIZE"]
    bound = 0.0
    for shape, size, rois in calls:
        level = net.levels_of(rois)
        for j, (level_shape, stride) in enumerate(zip(shape["levels"], net.STRIDES)):
            on_level = rois[level == j]
            if on_level.shape[0]:
                bound += roofline.roi_align_bound_s(level_shape, size, on_level, stride, pool)
    return 100.0 * bound / t
