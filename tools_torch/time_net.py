#!/usr/bin/env python
"""Per-stage timing of the propose pipeline with the PyTorch port (the
counterpart of ``tools/time_net.py``, the ``caffe time`` role), on the card
unless ``--cpu``: preprocess, trunk, search and end-to-end, in ms per image
and img/s. Every stage runs twice before any is timed; on the card each is
then timed by CUDA events over ``--reps`` calls, on the CPU by the host
clock. Prints the card's name and power limit first."""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools_torch import _common  # noqa: E402


def stage_ms(fn, x, reps: int, cuda: bool) -> float:
    """Mean ms per call of ``fn(x)`` over ``reps`` calls."""
    import torch

    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(x)
    return (time.perf_counter() - t0) * 1e3 / reps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="aznet_tpu_torch stage timings")
    p.add_argument("--cfg", default=None)
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=[])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--raw-hw", type=int, nargs=2, default=(375, 500))
    p.add_argument("--canvas", type=int, nargs=2, default=(608, 800))
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="calibrate + time the int8 trunk / int8 heads (vgg16 only)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from aznet_tpu_torch import api
    from aznet_tpu_torch.search.propose import az_search

    cfg = _common.load_config(args.cfg, args.set_cfgs)
    dev = _common.device(args)
    net = api.build_az_net(cfg, device=dev)
    canvas = tuple(args.canvas)
    if args.int8:
        from aznet_tpu_torch.ops.quant import (calibrate_head_int8, calibrate_trunk_int8,
                                               with_int8_scales)

        calib = np.random.RandomState(7).randint(0, 256, (2,) + canvas + (3,)).astype(np.float32)
        calib -= np.asarray(cfg.PIXEL_MEANS, np.float32)
        scales = calibrate_trunk_int8(net, calib, batch_size=2)
        head_scales = calibrate_head_int8(net, calib, scales)
        cfg = with_int8_scales(cfg, scales, head_scales)
        net = api.build_az_net(cfg, state_dict=net.params, device=dev)
        print(f"# int8: {len(scales)}+2 scales calibrated", flush=True)
    print(f"# device: {_common.card_line(net.device)}", flush=True)
    b = args.batch
    ims = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (b,) + tuple(args.raw_hw) + (3,)).astype(np.uint8)).to(net.device)
    model = net.model

    def prep(x):
        return api._preprocess(cfg, x, canvas)[1]

    def trunk(x):
        return api._maybe_quantize_feat(cfg, model.features(x))

    def search(feats):
        return [az_search(model.roi_forward, f, canvas, cfg.SEAR,
                          num_templates=cfg.MODEL.NUM_TEMPLATES, offset=cfg.BOX_OFFSET)
                for f in feats]

    e2e = api.make_propose_batch(model, cfg, canvas)
    with torch.inference_mode():
        blobs = prep(ims)
        feats = trunk(blobs)
        stages = (("preprocess", prep, ims), ("trunk", trunk, blobs), ("search", search, feats),
                  ("end-to-end", e2e, ims))
        for _ in range(2):
            for _, fn, x in stages:
                fn(x)
        cuda = net.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        for name, fn, x in stages:
            ms = stage_ms(fn, x, args.reps, cuda)
            print(f"{name:12s}: {ms / b:7.2f} ms/img  ({b * 1e3 / ms:7.1f} img/s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
