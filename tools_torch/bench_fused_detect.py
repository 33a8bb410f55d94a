#!/usr/bin/env python
"""Fused shared-trunk detection against the two-program path with the
PyTorch port: the counterpart of ``tools/bench_fused_detect.py``, on the
card unless ``--cpu``.

``detect_all_batched(fused=True)`` runs trunk -> AZ search -> Fast R-CNN
head as one program per batch on the AZ net's trunk; ``fused=False`` runs
proposal and detection apart (two trunk calls). Both run on the same
``share_trunk``'d nets, so the detections must agree: ``identical`` is the
reference's test (every row within 1e-3), ``unmatched`` the share of the
rows of either path with no row of the other, same class and image, within
``SCORE_TOL`` in score and ``BOX_TOL`` pixels (in bf16 the two programs
round their rois apart, which can move a detection across the per-image
cap or an NMS decision). The speedup is the removed trunk call. Each path runs one warm-up batch, then a timed pass over
``--max-images`` (host clock around the whole pass, whose results end on
the host).

Usage:
  python tools_torch/bench_fused_detect.py --imdb synthetic_hard_test \\
      --cfg experiments/cfgs/az_vgg_w100_synthetic_hard.yml \\
      --ckpt output/quality_torch/az --frcnn-ckpt output/quality_torch/frcnn
Prints one JSON line {"fused_img_per_sec", "unfused_img_per_sec",
"speedup", "map_fused", "map_unfused", "identical", "unmatched",
"trunks_value_equal", "device"}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCORE_TOL, BOX_TOL = 1e-2, 1.0


def unmatched_share(a, b) -> float:
    """The share of the rows of two ``all_boxes`` (``[class][image] -> [N,
    5]``) with no row of the other, same class and image, within
    ``SCORE_TOL`` in score and ``BOX_TOL`` in every coordinate."""
    import numpy as np

    def matched(x, y):
        if not (len(x) and len(y)):
            return np.zeros(len(x), bool)
        return ((np.abs(x[:, None, :4] - y[None, :, :4]).max(-1) <= BOX_TOL)
                & (np.abs(x[:, None, 4] - y[None, :, 4]) <= SCORE_TOL)).any(1)

    miss = total = 0
    for ca, cb in zip(a[1:], b[1:]):
        for x, y in zip(ca, cb):
            miss += int((~matched(x, y)).sum() + (~matched(y, x)).sum())
            total += len(x) + len(y)
    return miss / max(total, 1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="aznet_tpu_torch fused vs two-program detect")
    p.add_argument("--imdb", default="synthetic_hard_test")
    p.add_argument("--cfg", default=None)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--frcnn-ckpt", required=True)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from aznet_tpu_torch.api import build_az_net, build_frcnn_net, share_trunk
    from aznet_tpu_torch.data.imdb import get_imdb
    from aznet_tpu_torch.eval.detection import detect_all_batched
    from aznet_tpu_torch.eval.voc_eval import eval_detections_on_roidb
    from tools_torch import _common

    cfg = _common.load_config(args.cfg)
    dev = _common.device(args)
    imdb = get_imdb(args.imdb)
    az_net = _common.load_net(build_az_net, cfg, args.ckpt, dev)
    frcnn_net = _common.load_net(build_frcnn_net, cfg, args.frcnn_ckpt, dev)
    # With a Fast R-CNN trained on the AZ trunk (--init-trunk-from), sharing
    # changes nothing and the mAPs are the detector's; otherwise only the
    # fused-vs-two-program agreement and speedup mean anything.
    trunk_keys = [k for k in az_net.params if k.startswith("trunk.")]
    trunks_equal = all(torch.equal(az_net.params[k], frcnn_net.params[k]) for k in trunk_keys)
    share_trunk(frcnn_net, az_net)

    n = min(imdb.num_images, args.max_images or imdb.num_images)
    results, boxes = {}, {}
    for fused in (True, False):  # fused first: it warms the image cache for both
        name = "fused" if fused else "unfused"
        detect_all_batched(az_net, frcnn_net, imdb, fused=fused, batch_size=args.batch_size,
                           max_images=min(args.batch_size, n))
        t0 = time.perf_counter()
        all_boxes = detect_all_batched(az_net, frcnn_net, imdb, fused=fused,
                                       batch_size=args.batch_size, max_images=n)
        dt = time.perf_counter() - t0
        results[f"{name}_img_per_sec"] = n / dt
        boxes[name] = all_boxes
        aps = eval_detections_on_roidb([c[:n] for c in all_boxes], imdb.roidb[:n],
                                       imdb.num_classes)
        results[f"map_{name}"] = float(aps["mAP"])

    same = all(a.shape == b.shape and np.allclose(a, b, atol=1e-3)
               for ca, cb in zip(boxes["fused"], boxes["unfused"]) for a, b in zip(ca, cb))
    results["speedup"] = results["fused_img_per_sec"] / results["unfused_img_per_sec"]
    results["identical"] = bool(same)
    results["unmatched"] = unmatched_share(boxes["fused"], boxes["unfused"])
    results["trunks_value_equal"] = bool(trunks_equal)
    if not trunks_equal:
        results["map_note"] = ("trunks differ; mAP is for the share_trunk'd mismatched head: "
                               "use an --init-trunk-from Fast R-CNN snapshot for real mAP")
    results["device"] = _common.card_line(az_net.device)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
