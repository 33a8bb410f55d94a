"""The fused conv1 kernel's (conv1_2, ReLU, pool1) share of its roofline, in
%: one launch a call over the call's batch on the canvas, at the least time
of ``roofline.conv1_bound_s``, over the kernel's device time."""

from harness import readers, roofline


def read(run):
    t = readers.kernel_s(run, "conv1")
    if t <= 0:
        return None
    h, w = run.driver.canvas
    calls = sum(1 for c in run.calls if c.ok)
    return 100.0 * calls * roofline.conv1_bound_s(run.driver.images_per_call, h, w) / t
