#!/usr/bin/env python
"""The NMS kernel's parts on the serving shape with the PyTorch port: the
counterpart of ``tools/bench_nms_variants.py``, on the card unless
``--cpu``.

The reference compared its wrapper variants (``order_mode``, gathers,
unpermutes), which arrange data for the TPU's layout; the port's kernel
(``csrc/nms.cu``) sorts, builds the mask and scans in three launches of its
own. At ``--batch x --n`` (boxes xy uniform in [0, 2000], wh in [5, 300],
uniform scores, seed 3, IoU 0.5) it times:

- ``batched``: the whole call (``ops/nms.py::nms_mask_batched``);
- ``kernel_only``: the same call on input already sorted by score, the
  reference's kernel-only lower bound (the sort is then the identity);
- each pass's device time (``sort_kernel``, ``mask_kernel``,
  ``scan_kernel``; the ``_large`` kernels above 8192 boxes) by
  ``torch.profiler``, on the card only.

``--tile`` set the TPU kernel's tile: it is warned and ignored. ``HI - LO``
calls a trial (``--reps LO HI``) under ``tools_torch/_timing.py::event_time``.

Usage: python tools_torch/bench_nms_variants.py [--batch 16] [--n 4096] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

PASSES = ("sort_kernel", "mask_kernel", "scan_kernel")  # substrings of the kernels' names


def pass_device_us(run, iters: int = 10) -> dict:
    """{pass: mean device microseconds a call} of ``run``'s NMS launches under
    ``torch.profiler``; raises when the profiler saw none of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out = {p: sum(e.self_device_time_total for e in events if p in e.key) / iters
           for p in PASSES}
    if not any(out.values()):
        raise RuntimeError("the profiler saw no NMS pass on the card")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="aznet_tpu_torch NMS parts")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--tile", type=int, default=512,
                   help="the TPU kernel's tile: ignored by the port")
    p.add_argument("--reps", type=int, nargs=2, default=(4, 20))
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    if args.tile != 512:
        warnings.warn("--tile sets the TPU kernel's tile; the port ignores it", stacklevel=2)

    import torch

    from aznet_tpu_torch.api import _device
    from aznet_tpu_torch.ops.nms import nms_mask_batched
    from tools_torch import _common
    from tools_torch._timing import event_time, timer_for

    dev = _device(_common.device(args))
    print(f"# device: {_common.card_line(dev)}", flush=True)
    bsz, n = args.batch, args.n
    rng = np.random.RandomState(3)
    xy = rng.uniform(0, 2000, (bsz, n, 2)).astype(np.float32)
    wh = rng.uniform(5, 300, (bsz, n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = rng.rand(bsz, n).astype(np.float32)
    order = np.argsort(-scores, axis=1, kind="stable")
    inputs = {
        "batched": (boxes, scores),
        "kernel_only": (np.take_along_axis(boxes, order[..., None], 1),
                        np.take_along_axis(scores, order, 1)),
    }
    reps = args.reps[1] - args.reps[0]
    results = {}
    for name, (b_np, s_np) in inputs.items():
        b, s = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (b_np, s_np))
        run = lambda: nms_mask_batched(b, s, 0.5)  # noqa: E731
        t = event_time(run, reps=reps, trials=args.trials, timer=timer_for(dev))
        res = {"ms_per_call": t.seconds * 1e3, "mboxes_per_sec": bsz * n / t.seconds / 1e6,
               "trials_ms": [d * 1e3 for d in t.trials]}
        line = (f"{name:12s} {t.seconds * 1e3:7.3f} ms/call  ({bsz * n / t.seconds / 1e6:7.2f} "
                f"Mboxes/s; trials {', '.join(f'{d * 1e3:.4f}' for d in t.trials)})")
        if dev.type == "cuda":
            res["device_us"] = pass_device_us(run)
            line += "; device " + ", ".join(f"{k.split('_')[0]} {v:.2f} us"
                                            for k, v in res["device_us"].items())
        results[name] = res
        print(line, flush=True)
    print(json.dumps({"tool": "bench_nms_variants", "device": _common.card_line(dev),
                      "batch": bsz, "n": n, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
