#!/usr/bin/env python
"""Single-image end-to-end demo with the PyTorch port (the counterpart of
``tools/demo.py``): AZ proposals, the Fast R-CNN head, per-class NMS, on the
card unless ``--cpu``. With no ``--image`` it runs on a synthetic
planted-boxes image. Writes an annotated PNG to ``--out`` where PIL is
installed."""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools_torch import _common  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="aznet_tpu_torch demo")
    p.add_argument("--image", default=None, help="path to an image (BGR read)")
    p.add_argument("--cfg", default=None)
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=[])
    p.add_argument("--ckpt", default=None)
    p.add_argument("--frcnn-ckpt", default=None)
    p.add_argument("--out", default="output/demo.png")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    import numpy as np

    from aznet_tpu_torch.api import build_az_net, build_frcnn_net, im_detect, im_propose
    from aznet_tpu_torch.ops.nms import nms
    from aznet_tpu_torch.utils.timer import Timer

    cfg = _common.load_config(args.cfg, args.set_cfgs)
    dev = _common.device(args)
    if args.image:
        from aznet_tpu_torch.data.imdb import _imread_bgr

        im = _imread_bgr(args.image)
        classes = None
    else:
        from aznet_tpu_torch.data.synthetic import CLASSES, make_image

        im, gt, _ = make_image(np.random.RandomState(0), 384, 512)
        classes = CLASSES
        print(f"synthetic image with {gt.shape[0]} planted boxes")

    az = _common.load_net(build_az_net, cfg, args.ckpt, dev)
    frcnn = _common.load_net(build_frcnn_net, cfg, args.frcnn_ckpt, dev)

    t = Timer()
    t.tic()
    dets = im_propose(az, im)
    print(f"im_propose: {dets.shape[0]} proposals in {t.toc(False):.3f}s")
    t.tic()
    scores, boxes = im_detect(frcnn, im, dets[:, :4])
    print(f"im_detect: {scores.shape} in {t.toc(False):.3f}s")

    results = []
    for c in range(1, cfg.MODEL.NUM_CLASSES):
        keep = scores[:, c] > cfg.TEST.SCORE_THRESH
        cls_dets = np.concatenate(
            [boxes[keep, 4 * c: 4 * c + 4], scores[keep, c: c + 1]], 1).astype(np.float32)
        if cls_dets.shape[0]:
            cls_dets = cls_dets[nms(cls_dets, cfg.TEST.NMS)]
        for d in cls_dets[:5]:
            results.append((c, d))
    results.sort(key=lambda r: -r[1][4])
    for c, d in results[:10]:
        name = classes[c] if classes and c < len(classes) else f"cls{c}"
        print(f"  {name}: score={d[4]:.3f} box=({d[0]:.0f},{d[1]:.0f},{d[2]:.0f},{d[3]:.0f})")

    try:
        from PIL import Image, ImageDraw
    except ImportError:
        print("PIL unavailable; skipped visualization")
        return 0
    vis = Image.fromarray(np.ascontiguousarray(im[:, :, ::-1]))  # BGR -> RGB
    draw = ImageDraw.Draw(vis)
    for d in dets[:20]:
        draw.rectangle([d[0], d[1], d[2], d[3]], outline=(255, 255, 0))
    for c, d in results[:10]:
        draw.rectangle([d[0], d[1], d[2], d[3]], outline=(255, 0, 0), width=2)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    vis.save(args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
