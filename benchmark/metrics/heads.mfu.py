"""The head's share of the card's bf16 peak, in %, over the card's busy
time: the head's FLOPs that the traffic fixes (its network's ``head_flops``
over the given boxes), times the images, over the device time of the
operations that start between each call's trunk exit (where the
benchmark's hook waits for the card) and the call's end, less ROI align's
kernels and the copies. What is left is the head's kernels and the few
small kernels of the scores and decoded boxes; the card's idle time, which
the host's per-image loop sets, is not in it. For the C4 detector it is
conv5_x's share of its roofline, conv5_x being nearly all of the head's
FLOPs. Detection cells on one feature map only: on a pyramid the pooling is
more than ROI align's kernels, and it reads nothing."""

from harness import readers, roofline, trace as tr


def read(run):
    trunk = run.trace["spans"].get("trunk", ([], []))[0]
    if (run.driver.kind != "frcnn" or len(trunk) != len(run.calls)
            or any(tr.is_pyramid_shape(shape) for shape, _, _ in run.trace["rois"])):
        return None
    roi = roofline.KERNELS["roi_align"]
    busy_ns = 0
    for (_, t_out), call in zip(trunk, run.calls):
        busy_ns += sum(b - a for n, a, b in run.trace["events"]
                       if t_out <= a < call.end and not tr.is_copy(n) and not roi.search(n))
    if not busy_ns:
        return None
    flops = roofline.head_flops(run.cell.conf["MODEL"], "frcnn",
                                run.cell.traffic["rois"]) * readers.images(run)
    return 100.0 * flops / (busy_ns / 1e9 * roofline.PEAK_OPS["bf16"])
