#!/usr/bin/env python
"""Evaluate proposals (recall) or full detection (mAP) on an imdb with the
PyTorch port (the counterpart of ``tools/test_net.py``), on the card unless
``--cpu``. Prints the same JSON as the reference tool.

Examples:
  python tools_torch/test_net.py --mode recall --imdb synthetic_test --ckpt output/az
  python tools_torch/test_net.py --mode detect --imdb synthetic_hard_test \
      --ckpt az_ckpt_dir --frcnn-ckpt frcnn_ckpt_dir --batched
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools_torch import _common  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate an aznet_tpu_torch network")
    p.add_argument("--mode", choices=("recall", "detect"), default="recall")
    p.add_argument("--imdb", default="synthetic_test")
    p.add_argument("--cfg", default=None)
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=[])
    p.add_argument("--ckpt", default=None, help="AZ checkpoint dir")
    p.add_argument("--frcnn-ckpt", default=None, help="FRCNN checkpoint dir")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--batched", action="store_true",
                   help="batched propose/detect (canvas-bucketed; faster)")
    p.add_argument("--batch-size", type=int, default=16,
                   help="images per device batch in --batched mode")
    p.add_argument("--int8", action="store_true",
                   help="calibrate + run the int8 trunk (vgg16 only)")
    p.add_argument("--calib-images", type=int, default=8,
                   help="imdb images used for int8 activation calibration")
    p.add_argument("--refine", action="store_true",
                   help="recall mode: second decode pass, re-regress each proposal "
                        "through the FRCNN bbox head (--frcnn-ckpt) before the "
                        "recall table")
    p.add_argument("--share-trunk", action="store_true",
                   help="detect mode: the FRCNN net runs the AZ net's trunk "
                        "(api.share_trunk); with --batched, detect takes the fused "
                        "single-program path; pair with an FRCNN checkpoint trained "
                        "with train_net --init-trunk-from")
    p.add_argument("--output", default="output/eval")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def detection_aps(all_boxes, imdb, n, output):
    """The imdb's own protocol on a full run (VOC <= 2009 the 11-point
    metric), else the generic roidb matcher; then the same matcher at IoU
    0.7, as ``<class>@0.7``."""
    from aznet_tpu_torch.eval.voc_eval import eval_detections_on_roidb

    aps = None
    if n == imdb.num_images:
        try:
            aps = imdb.evaluate_detections(all_boxes, output)
        except NotImplementedError:
            aps = None
    sub = [cls_dets[:n] for cls_dets in all_boxes]
    roidb = imdb.roidb[:n]
    if aps is None:
        aps = eval_detections_on_roidb(sub, roidb, imdb.num_classes)
    aps70 = eval_detections_on_roidb(sub, roidb, imdb.num_classes, ovthresh=0.7)
    aps = dict(aps)
    aps.update({f"{k}@0.7": v for k, v in aps70.items()})
    return aps


def main(argv=None) -> int:
    args = parse_args(argv)
    from aznet_tpu_torch.api import build_az_net, build_frcnn_net, share_trunk
    from aznet_tpu_torch.data.imdb import get_imdb
    from aznet_tpu_torch.eval import detection

    cfg = _common.load_config(args.cfg, args.set_cfgs)
    dev = _common.device(args)
    if args.mode == "recall" and args.refine and not args.frcnn_ckpt:
        raise SystemExit("--refine needs --frcnn-ckpt (the bbox head doing the second "
                         "decode pass)")
    imdb = get_imdb(args.imdb)
    az_net = _common.load_net(build_az_net, cfg, args.ckpt, dev)
    if args.int8:
        from aznet_tpu_torch.ops.quant import calibrate_net_on_imdb

        az_net = calibrate_net_on_imdb(az_net, imdb, n_images=args.calib_images)
        print(f"int8 trunk calibrated on {args.calib_images} images")

    if args.mode == "recall":
        refine_net = None
        if args.refine:
            refine_net = _common.load_net(build_frcnn_net, cfg, args.frcnn_ckpt, dev)
        table = detection.evaluate_recall(az_net, imdb, max_images=args.max_images,
                                          batched=args.batched, batch_size=args.batch_size,
                                          refine_net=refine_net)
        print(json.dumps({str(k): {str(t): round(v, 4) for t, v in row.items()}
                          for k, row in table.items()}, indent=2))
        return 0
    frcnn_net = _common.load_net(build_frcnn_net, cfg, args.frcnn_ckpt, dev)
    if args.share_trunk:
        share_trunk(frcnn_net, az_net)
        print("trunk shared: fused single-program detect path enabled")
    cache = os.path.join(args.output, "detections.pkl")
    if args.batched:
        all_boxes = detection.detect_all_batched(az_net, frcnn_net, imdb,
                                                 batch_size=args.batch_size,
                                                 max_images=args.max_images, cache_file=cache)
    else:
        all_boxes = detection.detect_all(az_net, frcnn_net, imdb, max_images=args.max_images,
                                         cache_file=cache)
    aps = detection_aps(all_boxes, imdb, args.max_images or imdb.num_images, args.output)
    print(json.dumps({k: round(float(v), 4) for k, v in aps.items()}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
