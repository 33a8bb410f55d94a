#!/usr/bin/env python
"""The ROI-align implementations side by side with the PyTorch port: the
counterpart of ``tools/bench_roi.py``, on the card unless ``--cpu``, at the
ResNet-50 1080p search head's shape by default (a 68x120x1024 bf16 map, 128
ROIs a level, 4 images a call).

Variants (``--only``, comma-separated):
  xla_hfirst, xla_wfirst   the ``'align'`` einsums, H or W contracted first
  cuda_hfirst, cuda_wfirst the CUDA kernel (``csrc/roi_align.cu``) in each
                           of its two orders (its plain version on the CPU)
The reference's ``pallas_big`` variants are TPU tilings of the kernel.

Each call pools every image of the batch; ``HI - LO`` calls a trial
(``--reps LO HI``) under ``tools_torch/_timing.py::event_time``; the
trials' spread is printed.

Usage: python tools_torch/bench_roi.py [--b 4] [--r 128] [--hw 68 120] [--c 1024] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def variants() -> dict:
    """name -> ``fn(feat [H, W, C], rois [R, 4]) -> [R, 7, 7, C]``."""
    from aznet_tpu_torch.ops import roi_pool as troi
    from aznet_tpu_torch.ops.cuda import roi_align_kernel

    def fused(w_first):
        def fn(f, r):
            if f.is_cuda:
                return roi_align_kernel.roi_align_cuda(f, r, 1 / 16.0, 7, w_first)
            return troi.roi_align_fused_reference(f, r, 1 / 16.0, 7, w_first)
        return fn

    return {
        "xla_hfirst": lambda f, r: troi.roi_align(f, r, 1 / 16.0, 7, w_first=False),
        "xla_wfirst": lambda f, r: troi.roi_align(f, r, 1 / 16.0, 7, w_first=True),
        "cuda_hfirst": fused(False),
        "cuda_wfirst": fused(True),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="aznet_tpu_torch ROI-align variants")
    p.add_argument("--b", type=int, default=4)
    p.add_argument("--r", type=int, default=128)
    p.add_argument("--hw", type=int, nargs=2, default=(68, 120))
    p.add_argument("--c", type=int, default=1024)
    p.add_argument("--reps", type=int, nargs=2, default=(2, 10))
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--only", default=None, help="comma list of variants")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    import torch

    from aznet_tpu_torch.api import _device
    from tools_torch import _common
    from tools_torch._timing import event_time, timer_for

    dev = _device(_common.device(args))
    print(f"# device: {_common.card_line(dev)}", flush=True)
    h, w = args.hw
    b, r, c = args.b, args.r, args.c
    rng = np.random.RandomState(0)
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(
        dev, getattr(torch, args.dtype))
    rois = np.zeros((b, r, 4), np.float32)
    rois[..., 0] = rng.uniform(0, (w - 8) * 16, (b, r))
    rois[..., 1] = rng.uniform(0, (h - 8) * 16, (b, r))
    rois[..., 2] = rois[..., 0] + rng.uniform(32, 1200, (b, r))
    rois[..., 3] = rois[..., 1] + rng.uniform(32, 800, (b, r))
    rois = torch.from_numpy(rois).to(dev)

    fns = variants()
    if args.only:
        unknown = set(args.only.split(",")) - set(fns)
        if unknown:
            raise ValueError(f"unknown variants {sorted(unknown)}; the port has {sorted(fns)}")
        fns = {k: v for k, v in fns.items() if k in args.only.split(",")}
    reps = args.reps[1] - args.reps[0]
    results = {}
    with torch.inference_mode():
        for name, fn in fns.items():
            t = event_time(lambda: [fn(feat[i], rois[i]) for i in range(b)], reps=reps,
                           trials=args.trials, timer=timer_for(dev))
            results[name] = {"ms_per_call": t.seconds * 1e3,
                             "ms_per_img_level": t.seconds / b * 1e3,
                             "trials_ms": [d * 1e3 for d in t.trials]}
            print(f"{name:14s} {t.seconds * 1e3:8.3f} ms/call ({t.seconds / b * 1e3:7.3f} "
                  f"ms/img-level; trials {', '.join(f'{d * 1e3:.3f}' for d in t.trials)})",
                  flush=True)
    print(json.dumps({"tool": "bench_roi", "device": _common.card_line(dev), "b": b, "r": r,
                      "hw": [h, w], "c": c, "dtype": args.dtype, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
