#!/usr/bin/env python
"""Training-step benchmark of the PyTorch port: step time, MFU and prefetch
overlap; the counterpart of ``tools/bench_train.py``, on the card unless
``--cpu``.

- step time: ``HI - LO`` steps a trial (``--steps LO HI``, the reference's
  scan-length difference) by CUDA events under
  ``tools_torch/_timing.py::event_time`` (two warm-up steps, the median of
  three trials, their spread reported); the batch is on the device before
  the timed steps, and each step updates the weights as training does;
- MFU: the floating-point operations of one step (forward, backward and
  the SGD update, counted by ``torch.utils.flop_counter.FlopCounterMode``
  on the same step) over the step time, against the H100's 989 TFLOP/s
  dense bf16 peak; on the card only;
- prefetch overlap: the host's minibatch build (the prefetcher's work a
  step, host clock over 5 builds) against the step time.

Usage:
  python tools_torch/bench_train.py [--net az|frcnn] [--cfg ...] [--set K V ...]
  python tools_torch/bench_train.py --cpu --smoke     # CPU sanity run
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H100_BF16_PEAK = 989e12  # dense, NVIDIA's data sheet (SXM, 700 W)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="aznet_tpu_torch training-step benchmark")
    p.add_argument("--net", choices=("az", "frcnn"), default="az")
    p.add_argument("--cfg", default=None)
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=[])
    p.add_argument("--canvas", type=int, nargs=2, default=(608, 800),
                   help="training blob shape (default: the 600x800 scale)")
    p.add_argument("--steps", type=int, nargs=2, default=(2, 6), metavar=("LO", "HI"),
                   help="HI - LO steps a timed trial")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--smoke", action="store_true", help="tiny smallnet config (CPU sanity)")
    p.add_argument("--ims-per-batch", type=int, default=0,
                   help="override TRAIN.IMS_PER_BATCH (0 = cfg value)")
    p.add_argument("--remat", action="store_true",
                   help="set TRAIN.REMAT_TRUNK (trunk rematerialization)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from aznet_tpu_torch.api import _device
    from aznet_tpu_torch.config import cfg_from_list
    from aznet_tpu_torch.data.imdb import get_imdb
    from aznet_tpu_torch.data.minibatch import get_az_minibatch, get_frcnn_minibatch
    from aznet_tpu_torch.train.train_az import (make_az_train_state, make_az_train_step,
                                                to_device)
    from aznet_tpu_torch.train.train_frcnn import make_frcnn_train_state, make_frcnn_train_step
    from tools_torch import _common
    from tools_torch._timing import event_time, timer_for

    cfg = _common.load_config(args.cfg)
    if args.smoke:
        cfg = cfg_from_list(cfg, [
            "MODEL.BACKBONE", "smallnet", "MODEL.FC_DIM", "32", "MODEL.NUM_TEMPLATES", "5",
            "MODEL.NUM_CLASSES", "4", "MODEL.COMPUTE_DTYPE", "float32",
            "TRAIN.SCALES", "(64,)", "TRAIN.MAX_SIZE", "96", "TRAIN.REGIONS_PER_IMAGE", "16"])
        args.canvas = (64, 96)
    if args.set_cfgs:
        cfg = cfg_from_list(cfg, args.set_cfgs)
    if args.ims_per_batch:
        cfg = cfg_from_list(cfg, ["TRAIN.IMS_PER_BATCH", str(args.ims_per_batch)])
    if args.remat:
        cfg = cfg_from_list(cfg, ["TRAIN.REMAT_TRUNK", "True"])
    dev = _device(_common.device(args))
    print(f"# device: {_common.card_line(dev)}", flush=True)

    canvas = tuple(args.canvas)
    rng = np.random.RandomState(0)
    imdb = get_imdb("synthetic_train" if args.smoke else "synthetic_hard_train")
    entries = [imdb.roidb[i % len(imdb.roidb)] for i in range(cfg.TRAIN.IMS_PER_BATCH)]

    def build_batch():  # the prefetcher's work a step
        if args.net == "az":
            return get_az_minibatch(imdb, entries, cfg, rng, canvas=canvas)
        props = [np.concatenate([e["boxes"].astype(np.float32),
                                 np.ones((e["boxes"].shape[0], 1), np.float32)], axis=1)
                 for e in entries]
        return get_frcnn_minibatch(imdb, entries, props, cfg, rng, canvas=canvas)

    n_host = 5
    t0 = time.perf_counter()
    for _ in range(n_host):
        batch_np = build_batch()
    host_ms = (time.perf_counter() - t0) / n_host * 1e3

    if args.net == "az":
        state = make_az_train_state(cfg, device=dev)
        step = make_az_train_step(state.model, pos_weights=(cfg.TRAIN.ZOOM_POS_WEIGHT,
                                                            cfg.TRAIN.ADJ_POS_WEIGHT),
                                  remat_trunk=cfg.TRAIN.REMAT_TRUNK)
    else:
        state = make_frcnn_train_state(cfg, device=dev)
        step = make_frcnn_train_step(state.model)
    batch = to_device(batch_np, dev)

    with FlopCounterMode(display=False) as counter:
        step(state, batch, 1)
    flops = counter.get_total_flops()
    lo, hi = args.steps
    t = event_time(lambda: step(state, batch, 1), reps=hi - lo, timer=timer_for(dev))
    if t.contended:
        print("# contended: trial spread exceeded 2x; minimum estimate", flush=True)
    dt = t.seconds

    b = int(batch["images"].shape[0])
    out = {
        "metric": f"train_step_{args.net}",
        "value": dt * 1e3,
        "unit": "ms/step",
        "trials_ms": [d * 1e3 for d in t.trials],
        "images_per_sec": b / dt,
        "batch": b,
        "remat": bool(cfg.TRAIN.REMAT_TRUNK),
        "canvas": list(canvas),
        "host_batch_ms": host_ms,
        # The share of the host's minibatch work a step hides behind it when
        # the prefetcher (train/loop.py) overlaps the two.
        "prefetch_overlap": min(1.0, dt * 1e3 / max(host_ms, 1e-9)),
        "step_tflops": flops / 1e12,
        "device": _common.card_line(dev),
    }
    if dev.type == "cuda":
        out["tflops_per_sec"] = flops / dt / 1e12
        out["mfu_vs_bf16_peak"] = flops / dt / H100_BF16_PEAK
        out["peak_tflops"] = H100_BF16_PEAK / 1e12
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
