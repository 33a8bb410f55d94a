#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``aznet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card and nvcc

1. Builds the CUDA NMS kernel from ``aznet_tpu_torch/csrc`` (into the
   git-ignored ``build/``).
2. Phase 1: holds the kernel's keep masks against its plain PyTorch version
   on the card, bit for bit: the search's shape (1 x 2048, IoU 0.7), the
   16 x 4096 stream shape (boxes uniform in [0, 2000] plus wh in [5, 300],
   IoU 0.5, seed 3), and tie-heavy streams with +-0, subnormal and invalid
   rows. Times both with CUDA events after warmup.
3. Phase 2: the bf16 VGG-16 propose path at full width (seeded random
   weights), ``make_propose_batch`` on two raw 375x500 uint8 images on a
   608x800 canvas and one ``im_propose`` call, with the NMS launch count
   reset just before and read just after; checks the proposals, holds the
   kernel against the plain version on the NMS inputs that run produced,
   and holds the port on the card against the port on the CPU on a small
   f32 smallnet config. Prints img/s from CUDA events after two warmups.

Prints the card's name and power limit, one JSON line of kernel records,
and, as the last line, ``{"ok": true, "device": {...}}``. Exits non-zero at
the first failure and when no CUDA device is present. Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

NMS_SOURCE = "aznet_tpu_torch/csrc/nms.cu"
NMS_REPLACES = "aznet_tpu/ops/pallas/nms_kernel.py:336"
BATCH = 2
RAW_HW = (375, 500)
CANVAS = (608, 800)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nms_inputs(seed, bsz, n, extent, tie_rows, dev):
    """Boxes uniform in [0, extent] plus wh in [5, 300]; uniform scores, except
    ``tie_rows`` streams with 8-level ties, +-0, subnormals and invalid rows."""
    import torch

    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, extent, (bsz, n, 2)).astype(np.float32)
    wh = rng.uniform(5, 300, (bsz, n, 2)).astype(np.float32)
    scores = rng.rand(bsz, n).astype(np.float32)
    valid = np.ones((bsz, n), bool)
    for b in range(tie_rows):
        scores[b] = np.floor(scores[b] * 8) / 8
        scores[b, : n // 8] = -0.0
        scores[b, n // 8: n // 6] = np.float32(1e-40)
        scores[b, n // 6: n // 5] = np.float32(-3e-39)
        valid[b] = rng.rand(n) > 0.1
    return [torch.from_numpy(a).to(dev) for a in
            (np.concatenate([xy, xy + wh], -1), scores, valid)]


def phase1_nms(dev):
    """Kernel vs plain on the card. Returns (max_abs_err, timings)."""
    import torch

    from aznet_tpu_torch.ops import nms as tnms

    cases = [  # name, seed, B, N, extent, tie streams, IoU, timed
        ("path_1x2048", 0, 1, 2048, 1000.0, 0, 0.7, True),
        ("cell_16x4096", 3, 16, 4096, 2000.0, 0, 0.5, True),
        ("ties_4x2048", 5, 4, 2048, 1000.0, 4, 0.7, False),
        ("ties_2x1000", 6, 2, 1000, 500.0, 2, 0.5, False),
    ]
    err = 0.0
    times = {}
    for name, seed, bsz, n, extent, ties, iou, timed in cases:
        boxes, scores, valid = nms_inputs(seed, bsz, n, extent, ties, dev)
        got = tnms.nms_mask_batched(boxes, scores, iou, valid)
        want = tnms.nms_mask_reference(boxes, scores, iou, valid)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs().max().item()
        err = max(err, diff)
        kept = int(want.sum())
        print(f"phase1 {name}: kept {kept}/{bsz * n}, max_abs_err {diff}", flush=True)
        check(diff == 0.0, f"NMS kernel disagrees with the plain version on {name}")
        check(0 < kept < int(valid.sum()), f"{name}: degenerate case, kept {kept}")
        if timed:
            k_ms = cuda_ms(lambda: tnms.nms_mask_batched(boxes, scores, iou, valid), 20, 3)
            p_ms = cuda_ms(lambda: tnms.nms_mask_reference(boxes, scores, iou, valid), 3, 1)
            times[name] = (k_ms, p_ms)
            print(f"phase1 {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"kernel {bsz * n / k_ms / 1e3:.2f} Mboxes/s", flush=True)
    return err, times


def phase2_propose(dev, cfg, raw_hw=RAW_HW, canvas=CANVAS):
    """The propose path of ``cfg``. Returns (launches, img/s, nms_err)."""
    import torch

    from aznet_tpu_torch import api
    from aznet_tpu_torch.ops import nms as tnms
    from aznet_tpu_torch.ops.cuda import nms_kernel

    t0 = time.perf_counter()
    net = api.build_az_net(cfg, device=dev)
    torch.cuda.synchronize()
    print(f"phase2 build_az_net: {time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in net.model.parameters())} params "
          f"({next(net.model.parameters()).dtype})", flush=True)
    rng = np.random.RandomState(0)
    ims_np = rng.randint(0, 256, (BATCH,) + raw_hw + (3,)).astype(np.uint8)
    images = torch.from_numpy(ims_np).to(dev)
    fn = api.make_propose_batch(net.model, cfg, canvas)

    # Record the NMS inputs of the measured run (the kernel's count is kept
    # by the wrapper itself; the recorder only copies its arguments).
    recorded = []
    launch = nms_kernel.nms_cuda_batched

    def recording(boxes, scores, thresh, valid, offset=1.0):
        recorded.append((boxes.clone(), scores.clone(), thresh, valid.clone(), offset))
        return launch(boxes, scores, thresh, valid, offset)

    nms_kernel.nms_cuda_batched = recording
    try:
        nms_kernel.LAUNCHES = 0
        boxes, scores, valid = fn(images)
        dets = api.im_propose(net, ims_np[0])
        torch.cuda.synchronize()
        launches = nms_kernel.LAUNCHES
    finally:
        nms_kernel.nms_cuda_batched = launch
    print(f"phase2 main path: nms launches {launches}", flush=True)
    check(launches >= BATCH + 1, f"NMS kernel launched {launches} times, expected >= {BATCH + 1}")

    h, w = raw_hw
    check(boxes.shape == (BATCH, cfg.SEAR.NUM_PROPOSALS, 4), f"boxes shape {tuple(boxes.shape)}")
    for i in range(BATCH):
        n = int(valid[i].sum())
        check(1 <= n <= cfg.SEAR.NUM_PROPOSALS, f"image {i}: {n} proposals")
        b, s = boxes[i, :n].float(), scores[i, :n].float()
        print(f"phase2 image {i}: {n} proposals, top score {s[0].item():.6f}", flush=True)
        check(bool(torch.isfinite(b).all() and torch.isfinite(s).all()), f"image {i}: non-finite")
        check(bool((b >= 0).all() and (b[:, 0::2] <= w).all() and (b[:, 1::2] <= h).all()),
              f"image {i}: boxes outside the {h}x{w} image")
        check(bool((s[1:] <= s[:-1]).all()), f"image {i}: scores not sorted")
        check(not valid[i, n:].any(), f"image {i}: valid rows after the first invalid one")
    check(dets.ndim == 2 and dets.shape[1] == 5
          and 1 <= dets.shape[0] <= cfg.SEAR.NUM_PROPOSALS
          and np.isfinite(dets).all(), f"im_propose gave {dets.shape}")
    print(f"phase2 im_propose: {dets.shape[0]} proposals", flush=True)

    nms_err = 0.0
    for rb, rs, th, rv, off in recorded:
        got = tnms.nms_mask_batched(rb, rs, th, rv, off)
        want = tnms.nms_mask_reference(rb, rs, th, rv, off)
        nms_err = max(nms_err, (got.float() - want.float()).abs().max().item())
    print(f"phase2 NMS on the path's {len(recorded)} inputs ({tuple(recorded[0][1].shape)}): "
          f"kernel vs plain max_abs_err {nms_err}", flush=True)
    check(nms_err == 0.0, "NMS kernel disagrees with the plain version on the path's inputs")

    ms = cuda_ms(lambda: fn(images), 5, 2)
    blobs = torch.zeros((BATCH,) + canvas + (3,), dtype=api._blob_dtype(cfg), device=dev)
    with torch.inference_mode():
        trunk_ms = cuda_ms(lambda: net.model.features(blobs), 5, 2)
    torch.cuda.reset_peak_memory_stats()
    fn(images)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ips = BATCH / (ms / 1e3)
    print(f"phase2 make_propose_batch b={BATCH}: {ms:.3f} ms/call, {ips:.2f} img/s; "
          f"trunk alone {trunk_ms:.3f} ms; peak {peak:.2f} GiB", flush=True)
    return launches, ips, nms_err


def phase2_reference(dev):
    """The port on the card against the port on the CPU, small f32 smallnet
    config, same seeded weights: proposals agree to 1e-4 (scores) and 1e-2
    pixels (boxes)."""
    import torch

    from aznet_tpu.config import Config, cfg_from_dict
    from aznet_tpu_torch import api

    cfg = cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 64, "NUM_TEMPLATES": 11,
                  "COMPUTE_DTYPE": "float32"},
        "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 256, "MAX_LEVELS": 3, "NUM_PROPOSALS": 50},
        "TEST": {"SCALES": (64,), "MAX_SIZE": 128}})
    cpu_net = api.build_az_net(cfg, device="cpu")
    gpu_net = api.build_az_net(cfg, state_dict=cpu_net.params, device=dev)
    im = np.random.RandomState(1).randint(0, 256, (96, 128, 3)).astype(np.uint8)
    want = api.im_propose(cpu_net, im)
    got = api.im_propose(gpu_net, im)
    check(got.shape == want.shape, f"card {got.shape} vs CPU {want.shape} proposals")
    d_s = float(np.abs(got[:, 4] - want[:, 4]).max())
    d_b = float(np.abs(got[:, :4] - want[:, :4]).max())
    print(f"phase2 reference (smallnet f32, card vs CPU): {got.shape[0]} proposals, "
          f"max |d score| {d_s:.3g}, max |d box| {d_b:.3g}", flush=True)
    check(d_s <= 1e-4 and d_b <= 1e-2, "card and CPU proposals disagree")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from aznet_tpu.config import Config
    from aznet_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    print(f"build: {lib_path.relative_to(_build.BUILD_ROOT.parent.parent)} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    print((lib_path.parent / "nvcc.log").read_text().strip(), flush=True)

    err1, times = phase1_nms(dev)
    # VGG-16 at full width, bf16 (Config()'s default), default search.
    launches, ips, err2 = phase2_propose(dev, Config())
    phase2_reference(dev)

    k_ms, p_ms = times["path_1x2048"]
    print(json.dumps({"kernels": [{
        "name": "nms_exact_greedy", "route": "cuda", "source": NMS_SOURCE,
        "replaces": NMS_REPLACES, "launches": launches, "max_abs_err": max(err1, err2),
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
