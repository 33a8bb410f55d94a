#!/usr/bin/env python
"""NMS throughput (Mboxes/s) of the PyTorch port: the counterpart of
``bench_nms.py``, on the card unless ``--cpu``. Prints one JSON line,
``{"metric": "nms_mboxes_per_sec", "value": <best tier>, "unit": "Mboxes/s",
"detail": {tier: rate}, ...}``, over the tiers:

- ``cuda_n8192``, ``cuda_n32768``: the CUDA kernel (``csrc/nms.cu``; 32768
  takes its large route), one stream, on the card only;
- ``plain_fixpoint_n4096``: the plain PyTorch version
  (``ops/nms.py::nms_mask_reference``) on the device;
- ``cpp_host_n8192``: the host library's greedy NMS (``utils/native.py``),
  host clock over 10 calls.

Boxes as the reference's: xy uniform in [0, 2000], wh in [5, 300], distinct
scores (a permutation), IoU 0.5, seed 3. Device tiers are timed by
``tools_torch/_timing.py::event_time``; the trials' spread is printed beside
each rate.

Usage: python tools_torch/bench_nms.py [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def dets_of(rng, n: int) -> np.ndarray:
    xy = rng.uniform(0, 2000, (n, 2))
    wh = rng.uniform(5, 300, (n, 2))
    s = rng.permutation(n).astype(np.float32) / n
    return np.concatenate([xy, xy + wh, s[:, None]], 1).astype(np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="aznet_tpu_torch NMS throughput")
    p.add_argument("--cpu", action="store_true", help="run the device tiers on the CPU")
    args = p.parse_args(argv)

    import torch

    from aznet_tpu_torch.ops import nms as tnms
    from tools_torch import _common
    from tools_torch._timing import event_time, timer_for

    dev = torch.device(_common.device(args))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
    rng = np.random.RandomState(3)
    results, trials = {}, {}

    def bench_device(name, fn, n, reps):
        d = torch.from_numpy(dets_of(rng, n)).to(dev)
        boxes, scores = d[None, :, :4].contiguous(), d[None, :, 4].contiguous()
        valid = torch.ones_like(scores, dtype=torch.bool)
        t = event_time(lambda: fn(boxes, scores, 0.5, valid), reps=reps, timer=timer_for(dev))
        results[f"{name}_n{n}"] = n / t.seconds / 1e6
        trials[f"{name}_n{n}"] = [x * 1e3 for x in t.trials]
        print(f"# {name}_n{n}: {n / t.seconds / 1e6:.3f} Mboxes/s (trials "
              f"{', '.join(f'{x * 1e3:.4f}' for x in t.trials)} ms a call)", flush=True)

    if dev.type == "cuda":
        for n in (8192, 32768):
            bench_device("cuda", tnms.nms_mask_batched, n, reps=20)
    bench_device("plain_fixpoint", tnms.nms_mask_reference, 4096,
                 reps=5 if dev.type == "cuda" else 1)

    d = dets_of(rng, 8192)
    tnms.nms(d, 0.5)  # builds the host library at first use
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        tnms.nms(d, 0.5)
    dt = (time.perf_counter() - t0) / reps
    results["cpp_host_n8192"] = 8192 / dt / 1e6

    print(json.dumps({"metric": "nms_mboxes_per_sec", "value": max(results.values()),
                      "unit": "Mboxes/s", "detail": results, "trials_ms": trials,
                      "device": _common.card_line(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
