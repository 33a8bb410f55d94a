#!/usr/bin/env python
"""COCO-protocol evaluation at full scale with the PyTorch port (host CPU):
the counterpart of ``tools/bench_coco_eval.py``.

It generates a synthetic detection set at COCO's post-NMS density (80
classes, ``--images`` images, about 7 objects and ``--dets-per-img``
detections an image; Zipf-like class frequencies, log-uniform sizes over
the small/medium/large ranges, 2% crowd boxes, jittered re-detections and
false positives mostly on classes present in the image) and times
``aznet_tpu_torch.eval.coco_eval.coco_eval`` end to end per matcher tier:

- ``native``: the host library's matcher (``csrc/host.cc::az_coco_match``),
  the port's default;
- ``numpy``: ``coco_eval._match_image_np``, the vectorised NumPy matcher.

Prints one JSON line per tier (wall seconds, dets/s, the AP/AR summary) and
raises when the tiers' summaries differ. A host tool: ``--cpu`` is accepted
for the tools' common command line and changes nothing.

Usage:
  python tools_torch/bench_coco_eval.py                 # both tiers
  python tools_torch/bench_coco_eval.py --images 500    # quick shape check
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_coco_scale_set(n_images: int = 5000, n_classes: int = 81,
                        dets_per_img: int = 100, seed: int = 0):
    """Synthetic (all_boxes, roidb) at COCO post-NMS density."""
    rng = np.random.RandomState(seed)
    n_fg = n_classes - 1
    # Zipf-ish class popularity (COCO: 'person' is ~30% of instances).
    pop = 1.0 / np.arange(1, n_fg + 1) ** 0.9
    pop /= pop.sum()
    roidb = []
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in range(n_images)]
                 for _ in range(n_classes)]
    img_hw = (480.0, 640.0)

    for i in range(n_images):
        n_gt = rng.poisson(7) + 1
        cls = rng.choice(n_fg, size=n_gt, p=pop) + 1
        # log-uniform sizes 8..400 px -> covers small/medium/large ranges
        w = np.exp(rng.uniform(np.log(8.0), np.log(400.0), n_gt))
        h = w * np.exp(rng.uniform(-0.7, 0.7, n_gt))
        x1 = rng.uniform(0, img_hw[1] - w)
        y1 = rng.uniform(0, img_hw[0] - np.minimum(h, img_hw[0] - 1))
        gt = np.stack([x1, y1, x1 + w - 1, y1 + h - 1], 1).astype(np.float32)
        crowd = rng.rand(n_gt) < 0.02
        roidb.append({"boxes": gt, "gt_classes": cls.astype(np.int64),
                      "crowd": crowd})

        # Detections: jittered copies of most gts + false positives.
        det_boxes, det_cls, det_scores = [], [], []
        for g in range(n_gt):
            if rng.rand() < 0.85:
                for _ in range(rng.randint(1, 4)):
                    bw, bh = gt[g, 2] - gt[g, 0], gt[g, 3] - gt[g, 1]
                    jit = rng.normal(0, 0.08, 4) * np.array([bw, bh, bw, bh])
                    det_boxes.append(gt[g] + jit)
                    det_cls.append(cls[g])
                    det_scores.append(rng.uniform(0.5, 1.0))
        n_fp = max(dets_per_img - len(det_boxes), 0)
        fw = np.exp(rng.uniform(np.log(8.0), np.log(300.0), n_fp))
        fh = fw * np.exp(rng.uniform(-0.7, 0.7, n_fp))
        fx = rng.uniform(0, img_hw[1] - fw)
        fy = rng.uniform(0, img_hw[0] - np.minimum(fh, img_hw[0] - 1))
        for j in range(n_fp):
            det_boxes.append(np.array(
                [fx[j], fy[j], fx[j] + fw[j] - 1, fy[j] + fh[j] - 1]))
            # 60% of FPs land on classes present in the image (confusions),
            # the rest anywhere — keeps per-(class,image) density realistic.
            det_cls.append(cls[rng.randint(n_gt)] if rng.rand() < 0.6
                           else rng.choice(n_fg, p=pop) + 1)
            det_scores.append(rng.uniform(0.01, 0.6))
        det_boxes = np.asarray(det_boxes, np.float32).reshape(-1, 4)
        det_cls = np.asarray(det_cls)
        det_scores = np.asarray(det_scores, np.float32)
        for c in np.unique(det_cls):
            m = det_cls == c
            all_boxes[int(c)][i] = np.concatenate(
                [det_boxes[m], det_scores[m, None]], 1).astype(np.float32)
    return all_boxes, roidb


@contextlib.contextmanager
def matcher_tier(tier: str):
    """``coco_eval``'s matcher for the run: the host library's (``native``,
    as it is) or ``_match_image_np`` under ``_match_image``'s contract
    (``numpy``)."""
    # the module: aznet_tpu_torch.eval re-exports a function of its name
    ce = importlib.import_module("aznet_tpu_torch.eval.coco_eval")
    if tier == "native":
        yield
        return
    if tier != "numpy":
        raise ValueError(f"unknown tier {tier!r}: native or numpy")

    def match_np(ious, gt_ignore, crowd, iou_thrs):
        n_t, (n_d, n_g) = len(iou_thrs), ious.shape
        if n_d == 0 or n_g == 0:
            return np.zeros((n_t, n_d), bool), np.zeros((n_t, n_d), bool)
        thrs = np.minimum(np.asarray(iou_thrs, np.float64), 1.0 - 1e-10)
        return ce._match_image_np(ious, gt_ignore, crowd, thrs)

    native = ce._match_image
    ce._match_image = match_np
    try:
        yield
    finally:
        ce._match_image = native


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="aznet_tpu_torch COCO eval at scale")
    p.add_argument("--images", type=int, default=5000)
    p.add_argument("--classes", type=int, default=81)
    p.add_argument("--dets-per-img", type=int, default=100)
    p.add_argument("--tiers", default="native,numpy",
                   help="comma list of matcher tiers to time: native,numpy")
    p.add_argument("--cpu", action="store_true", help="accepted; a host tool runs on the CPU")
    args = p.parse_args(argv)

    from aznet_tpu_torch.eval.coco_eval import coco_eval

    t0 = time.perf_counter()
    all_boxes, roidb = make_coco_scale_set(args.images, args.classes, args.dets_per_img)
    n_dets = sum(all_boxes[c][i].shape[0] for c in range(1, args.classes)
                 for i in range(args.images))
    print(f"# generated {args.images} images, {n_dets} dets ({n_dets / args.images:.1f}/img), "
          f"{sum(r['boxes'].shape[0] for r in roidb)} gts in {time.perf_counter() - t0:.1f}s",
          flush=True)

    results = {}
    for tier in args.tiers.split(","):
        with matcher_tier(tier):
            t0 = time.perf_counter()
            out = coco_eval(all_boxes, roidb, args.classes)
            dt = time.perf_counter() - t0
        summary = {k: float(out[k]) for k in ("AP", "AP50", "AP75", "AP_small", "AP_medium",
                                              "AP_large", "AR@1", "AR@10", "AR@100")}
        results[tier] = summary
        print(json.dumps({"tier": tier, "wall_s": dt, "dets_per_s": n_dets / dt, **summary}),
              flush=True)
    if len(results) == 2:
        a, b = results.values()
        if a != b:
            raise RuntimeError(f"tier results diverge: {a} vs {b}")
        print("# tiers agree on every metric", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
