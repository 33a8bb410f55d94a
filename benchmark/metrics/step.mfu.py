"""The whole step's share of the card's bf16 peak, in %: the FLOPs that the
configuration fixes an image (trunk convolutions on the canvas; fc6, fc7 and
the output dot over the frontier capacity of every level, or over the given
boxes), times the images, over the traced window. ROI align, decode, the
preprocess and NMS are not counted."""

from harness import readers, roofline


def read(run):
    d, model = run.driver, run.cell.conf["MODEL"]
    rows = (run.cell.traffic["rois"] if d.kind == "frcnn"
            else roofline.propose_rows(run.cell.conf["SEAR"]))
    flops = roofline.trunk_flops(model, d.canvas) + roofline.head_flops(model, d.kind, rows)
    return 100.0 * flops * readers.images(run) / (
        readers.traced_window_s(run) * roofline.PEAK_OPS["bf16"])
