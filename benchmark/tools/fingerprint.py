#!/usr/bin/env python3
"""What the yardstick reads of a cell, made from the seed alone, as one JSON
line a cell: the seeded weights' checksum, the checksums of the float32
reference's and the fp8 control's outputs on the cell's first image (its
features, the heads on given boxes and, for a propose cell, the reference's
whole search), the FLOPs behind ``step.mfu`` and the kernels' least times.
Two versions of the benchmark read the same on every seed exactly when a
change to the harness moved nothing of what it measures against.

    python3 benchmark/tools/fingerprint.py --seeds 5,6 [--root OTHER_CHECKOUT] [--tiny] [--gaps]

``--root`` reads the benchmark of another checkout (its ``benchmark/``
imported in place of this one's); ``--tiny`` cuts each cell to the CPU
tests' size (``tests/conftest.py::tiny_cell``); ``--gaps`` also runs the
program for one call and adds the numbers the check compares. Runs on the
card when there is one, else on the CPU."""

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def digest(tensors) -> str:
    """sha256 of the tensors' float32 bytes, in order, with their shapes."""
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().float().contiguous().cpu()
        h.update(repr(tuple(t.shape)).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def fingerprint(cell, seed: int, device, gaps: bool = False) -> dict:
    """The cell's yardstick readings on ``seed`` (see the module's doc)."""
    import time

    import torch

    from harness import check, inputs, roofline, runner, spec
    from harness.system import ReferenceSystem
    from reference import nets, search as rs

    conf, traffic = cell.conf, cell.traffic
    model, kind = conf["MODEL"], spec.driver_class(cell).kind
    hw = traffic["image_hw"]
    test = conf["TEST"]
    canvas = (tuple(conf["canvas"]) if traffic["driver"] != "im_propose"
              else nets.canvas_for(hw[0], hw[1], test["SCALES"][0], test["MAX_SIZE"]))
    weights = inputs.make_weights(model, kind, seed, device)
    out = {"workload": cell.name, "seed": seed, "kind": kind,
           "weights": digest(weights[k] for k in sorted(weights))}
    image = inputs.device_images(seed, 1, hw, device)[0]
    rois = torch.from_numpy(inputs.given_boxes(seed, 1, 64, hw, 16, (0.5, 2.0))[0]).to(device)
    ref = check.Reference(conf, kind, weights, device)
    feat, im_scale, vh, vw = ref.features(image, canvas)
    got = ref.roi_forward(feat, rois * im_scale)
    out["reference"] = digest([feat, *(got[k] for k in sorted(got))])
    control = ReferenceSystem(conf, kind, weights, device)
    got = control.roi_forward(feat, rois * im_scale)
    out["control"] = digest(got[k] for k in sorted(got))
    if kind == "az":
        found = rs.search(ref.roi_forward, feat, vh, vw, conf["SEAR"], conf["BOX_OFFSET"],
                          cell.limits.get(check.BAND_KEY, 0.0))
        out["search"] = digest([found.boxes, found.scores, found.valid, found.cand_boxes,
                                found.cand_scores])
    rows = traffic["rois"] if kind == "frcnn" else roofline.propose_rows(conf["SEAR"])
    out["trunk_flops"] = roofline.trunk_flops(model, canvas)
    out["head_flops"] = roofline.head_flops(model, kind, rows)
    out["roi_align_bound_s"] = roofline.roi_align_bound_s(
        tuple(feat.shape), 2, rois * im_scale, model["FEAT_STRIDE"], model["POOL_SIZE"])
    out["nms_bound_s"] = roofline.nms_bound_s(
        roofline.candidates(conf["SEAR"], model["NUM_TEMPLATES"]))
    out["conv1_bound_s"] = roofline.conv1_bound_s(traffic["batch"], *canvas)
    if gaps:
        del weights, ref, control, feat, got
        r = runner.run_cell(cell, seed, 0.0, False, device, time.perf_counter())
        out["checks"] = {k: c["value"] for k, c in r["checks"].items()}
    return out


def cells(bench_root: Path, tiny: bool) -> list:
    from harness import spec

    names = [w["name"] for w in spec.load_bench(bench_root)["workloads"]]
    if tiny:
        from conftest import tiny_cell

        return [tiny_cell(n) for n in names]
    return [spec.load_cell(n, root=bench_root) for n in names]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--root", default=str(ROOT), help="the checkout whose benchmark is read")
    p.add_argument("--tiny", action="store_true", help="cells at the CPU tests' size")
    p.add_argument("--gaps", action="store_true", help="also the check's numbers of one call")
    args = p.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "benchmark" / "tests"), str(root / "benchmark"), str(root)]

    import torch

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for cell in cells(root, args.tiny):
        for seed in (int(s) for s in args.seeds.split(",") if s):
            print(json.dumps(fingerprint(cell, seed, device, args.gaps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
