#!/usr/bin/env python
"""Proposal-generation throughput of the PyTorch port: the counterpart of
``bench.py``, on the card unless ``--cpu``.

Prints ONE JSON line, ``{"metric", "value", "unit", ...}``, with the
reference's metric names: batched proposal generation (raw uint8 BGR images
-> preprocess -> trunk -> zoom search -> NMS'd scored boxes) in img/s, the
best over the preset's batch sizes. Beside the value: the device, each
batch's img/s with the spread of its timed trials, and
``nms_mboxes_per_sec`` (the CUDA NMS kernel on 16 streams of 4096 boxes at
IoU 0.5) on the ``full`` preset on the card. ``vs_baseline`` is left out: it
divided by a TPU target. Launched at a world size above one (``torchrun``),
it runs the sharded propose (``parallel/inference.py``) with the batch split
over ``data``; the batches scale with the world size, as the reference's
with its device count.

Presets and knobs (environment, as the reference's):
  AZNET_BENCH_PRESET=full            VGG-16, 375x500 on 608x800 (default)
  AZNET_BENCH_PRESET=smoke           smallnet, a tiny config for CPU runs
  AZNET_BENCH_PRESET=coco_deep       deep tree, 1000 proposals, 480x640
  AZNET_BENCH_PRESET=resnet50_1080p  ResNet-50 on 1080x1920 frames
  AZNET_BENCH_BATCH=N                one batch size in place of the preset's
  AZNET_BENCH_DTYPE=int8|int8_heads|bfloat16   (int8 default for VGG-16:
                                     int8 chain trunk, int8 fc heads,
                                     INT8_ROI; bfloat16 for ResNet-50)
  AZNET_BENCH_CHAIN_FROM, AZNET_BENCH_INT8_BACKEND, AZNET_ROI_INT8=0,
  AZNET_BENCH_POOLING, AZNET_BENCH_S2D=0, AZNET_BENCH_NMS=0

Timing: ``tools_torch/_timing.py::event_time`` (CUDA events, two warm-up
calls, the median of three trials, retried when they spread more than 2x).
A batch size that runs out of device memory ends the sweep; any other error
stops the tool.

Usage: python tools_torch/bench.py [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

METRICS = {
    "smoke": "propose_images_per_sec_smoke",
    "coco_deep": "propose_images_per_sec_coco_deep_tree",
    "resnet50_1080p": "propose_images_per_sec_resnet50_1080p",
    "full": "propose_images_per_sec_vgg16_600x800",
}


def preset_config(preset: str):
    """``(cfg, raw_hw, canvas)`` of a preset, as ``bench.py::_build``."""
    from aznet_tpu_torch.config import Config, cfg_from_dict

    if preset == "smoke":
        cfg = cfg_from_dict(Config(), {
            "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 64, "NUM_TEMPLATES": 11,
                      "COMPUTE_DTYPE": "float32"},
            "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 256, "MAX_LEVELS": 2, "NUM_PROPOSALS": 50},
            "TEST": {"SCALES": (64,), "MAX_SIZE": 128}})
        return cfg, (96, 128), (64, 128)
    if preset == "coco_deep":  # experiments/cfgs/coco_deep_tree.yml's knobs
        cfg = cfg_from_dict(Config(), {
            "MODEL": {"NUM_CLASSES": 81},
            "SEAR": {"MAX_LEVELS": 8, "MIN_SIZE": 8.0, "FRONTIER_CAP": 128, "CAND_BUF": 4096,
                     "NUM_PROPOSALS": 1000}})
        return cfg, (480, 640), (608, 800)
    if preset == "resnet50_1080p":  # experiments/cfgs/resnet50_1080p.yml's knobs, one scale
        cfg = cfg_from_dict(Config(), {
            "MODEL": {"BACKBONE": "resnet50"},
            "TEST": {"SCALES": (1080,), "MAX_SIZE": 1920},
            "SEAR": {"MAX_LEVELS": 7, "FRONTIER_CAP": 128, "CAND_BUF": 4096,
                     "NUM_PROPOSALS": 1000}})
        return cfg, (1080, 1920), (1088, 1920)
    if preset != "full":
        raise ValueError(f"unknown AZNET_BENCH_PRESET {preset!r}")
    return Config(), (375, 500), (608, 800)  # VGG-16, the default search


def _calibrated(net, cfg, canvas, dtype, dev):
    """The int8 net of ``dtype`` (``int8`` or ``int8_heads``), calibrated on
    two random canvases as the reference does."""
    from aznet_tpu_torch import api
    from aznet_tpu_torch.config import cfg_from_dict
    from aznet_tpu_torch.ops import quant

    calib = np.random.RandomState(7).randint(0, 256, (2,) + canvas + (3,)).astype(np.float32)
    calib -= np.asarray(cfg.PIXEL_MEANS, np.float32)
    if cfg.MODEL.BACKBONE == "vgg16":
        scales = quant.calibrate_trunk_int8(net, calib, batch_size=2)
        head_scales = quant.calibrate_head_int8(net, calib, scales)
    else:
        scales = quant.calibrate_trunk_int8_resnet(net, calib, batch_size=1)
        head_scales = quant.calibrate_head_int8(net, calib, scales, batch_size=1)
    if dtype == "int8":
        cfg = quant.with_int8_scales(cfg, scales, head_scales)
        if cfg.MODEL.BACKBONE == "vgg16":
            for env, field in (("AZNET_BENCH_CHAIN_FROM", "INT8_CHAIN_FROM"),
                               ("AZNET_BENCH_INT8_BACKEND", "INT8_BACKEND")):
                if os.environ.get(env):
                    cfg = cfg_from_dict(cfg, {"MODEL": {field: os.environ[env]}})
    else:  # bf16 trunk + int8 heads
        cfg = dataclasses.replace(cfg, MODEL=dataclasses.replace(
            cfg.MODEL, INT8_HEAD_SCALES=tuple(head_scales)))
    if os.environ.get("AZNET_ROI_INT8", "1") != "0":
        cfg = cfg_from_dict(cfg, {"MODEL": {"INT8_ROI": True}})
    net = api.build_az_net(cfg, state_dict=net.params, device=dev)
    print(f"# dtype={dtype} ({len(scales)}+2 scales) roi_int8={cfg.MODEL.INT8_ROI}", flush=True)
    return net


def build(preset: str, dev, world: int = 1):
    """``(net, fn, raw_hw)``: the preset's net on ``dev`` (seeded weights),
    calibrated to int8 where the dtype asks for it (not on the CPU, as the
    reference), and its batched propose function (sharded over ``data`` at
    ``world`` > 1)."""
    from aznet_tpu_torch import api
    from aznet_tpu_torch.config import cfg_from_dict

    cfg, raw_hw, canvas = preset_config(preset)
    mesh = None
    if world > 1:  # the mesh first: it sets this rank's card
        from aznet_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(world, device=dev)
        dev = mesh.device
    if os.environ.get("AZNET_BENCH_POOLING"):
        cfg = cfg_from_dict(cfg, {"MODEL": {"POOLING_MODE": os.environ["AZNET_BENCH_POOLING"]}})
    if os.environ.get("AZNET_BENCH_S2D") == "0":
        cfg = cfg_from_dict(cfg, {"MODEL": {"STEM_S2D": False}})
    net = api.build_az_net(cfg, device=dev)
    dtype = os.environ.get("AZNET_BENCH_DTYPE",
                           "bfloat16" if cfg.MODEL.BACKBONE == "resnet50" else "int8")
    if (dtype in ("int8", "int8_heads") and cfg.MODEL.BACKBONE in ("vgg16", "resnet50")
            and net.device.type != "cpu"):
        net = _calibrated(net, net.cfg, canvas, dtype, dev)
    if mesh is not None:
        from aznet_tpu_torch.parallel.inference import make_sharded_propose

        fn = make_sharded_propose(net.model, net.cfg, canvas, mesh)
    else:
        fn = api.make_propose_batch(net.model, net.cfg, canvas)
    return net, fn, raw_hw


def default_batches(preset: str, n_dev: int) -> list:
    if os.environ.get("AZNET_BENCH_BATCH"):
        return [int(os.environ["AZNET_BENCH_BATCH"])]
    per = {"smoke": [2], "coco_deep": [16], "resnet50_1080p": [4]}.get(preset, [16, 32])
    return [b * n_dev for b in per]


def nms_secondary(dev) -> tuple:
    """``(Mboxes/s, Timing)`` of the CUDA NMS kernel on 16 streams of 4096
    boxes (xy uniform in [0, 2000], wh in [5, 300], uniform scores, seed 3)
    at IoU 0.5, as the reference's secondary metric."""
    import torch

    from aznet_tpu_torch.ops.nms import nms_mask_batched
    from tools_torch._timing import event_time

    n, batch = 4096, 16
    rng = np.random.RandomState(3)
    xy = rng.uniform(0, 2000, (batch, n, 2)).astype(np.float32)
    wh = rng.uniform(5, 300, (batch, n, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1)).to(dev)
    scores = torch.from_numpy(rng.rand(batch, n).astype(np.float32)).to(dev)
    t = event_time(lambda: nms_mask_batched(boxes, scores, 0.5), reps=20)
    return batch * n / t.seconds / 1e6, t


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="aznet_tpu_torch proposal throughput "
                                "(presets and knobs by environment, see the docstring)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (host-clock timing)")
    args = p.parse_args(argv)

    import torch

    from tools_torch import _common
    from tools_torch._timing import event_time, timer_for

    preset = os.environ.get("AZNET_BENCH_PRESET", "full")
    dev = _common.device(args)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    net, fn, raw_hw = build(preset, dev, world)
    dev = net.device
    rank0 = int(os.environ.get("RANK", "0")) == 0
    print(f"# device: {_common.card_line(dev)}", flush=True)
    rng = np.random.RandomState(0)
    reps = 1 if preset == "smoke" else 2

    per_batch, best, any_contended = {}, 0.0, False
    for b in default_batches(preset, world):
        ims = torch.from_numpy(rng.randint(0, 256, (b,) + raw_hw + (3,)).astype(np.uint8)).to(dev)
        try:
            t = event_time(lambda: fn(ims), reps=reps, timer=timer_for(dev))
        except torch.cuda.OutOfMemoryError:  # keep the best batch that fit
            print(f"# batch {b} failed: OutOfMemoryError", flush=True)
            break
        if not np.isfinite(t.seconds) or t.seconds <= 0:
            raise RuntimeError(f"batch {b}: no positive per-call time survived the retries")
        ips = b / t.seconds
        per_batch[str(b)] = {"img_per_sec": ips, "ms_per_call": t.seconds * 1e3,
                             "trials_ms": [d * 1e3 for d in t.trials]}
        print(f"# batch {b}: {ips:.2f} img/s (trials {', '.join(f'{d * 1e3:.2f}' for d in t.trials)}"
              f" ms a call){' contended' if t.contended else ''}", flush=True)
        best = max(best, ips)
        any_contended = any_contended or t.contended

    out = {"metric": METRICS.get(preset, METRICS["full"]), "value": best, "unit": "img/s",
           "device": _common.card_line(dev), "world_size": world, "batches": per_batch}
    if any_contended:
        out["contended"] = True
    if preset == "full" and dev.type == "cuda" and os.environ.get("AZNET_BENCH_NMS", "1") != "0":
        rate, t = nms_secondary(dev)
        out["nms_mboxes_per_sec"] = rate
        out["nms_trials_ms"] = [d * 1e3 for d in t.trials]
        if t.contended:
            out["contended"] = True
    if rank0:
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
