#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``aznet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card and nvcc

1. Builds the CUDA kernels from ``aznet_tpu_torch/csrc`` (into the
   git-ignored ``build/``): NMS, the int8 conv, ROI align, fused conv1.
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
4. Phase 3: the int8 conv kernel alone (``aznet_tpu_torch/csrc/conv_int8.cu``)
   at the 10 int8 layer shapes of the main path (b=2, 608x800 canvas:
   conv2_2 .. conv5_3), non-power-of-two scales: the chain entry (fused pool)
   where a pool follows, the strip entry elsewhere; plus the strip entry at
   conv2_2's shape without the pool and at a C=64 input. Kernel equals plain
   bit for bit (int8 codes, bf16 exit); both timed with CUDA events.
5. Phase 4: the int8 VGG-16 propose path at full width: the bf16 net of
   phase 2 is calibrated on two random canvases (``RandomState(7)`` minus
   the pixel means) and rebuilt int8 (int8 trunk from conv2_2, int8 fc6/fc7,
   int8 ROI align) from its float32 parameters; the launch counts of both
   conv entries and of NMS are reset just before ``make_propose_batch`` (b=2)
   and one ``im_propose``, and read just after. Same proposal checks as
   phase 2; the conv kernel's inputs of that run are held against the plain
   version; int8 vs bf16 trunk features cosine > 0.98; int8 img/s beside the
   bf16 img/s of phase 2. Then the int8 port on the card against the port on
   the CPU (VGG-16 at WIDTH 0.125, strip entry, fixed scales).
6. Phase 5: the fused ROI-align kernel (``csrc/roi_align.cu``) alone on the
   38x50x512 trunk map of a 608x800 canvas: bf16 at R = 8, 64 and 300
   (H-first by the order rule) and f32 at R = 64 (W-first), bit for bit
   against its plain version; the fused conv1 kernel (``csrc/conv1_fused.cu``)
   at b=2, 608x800x64 bf16, within one bf16 ulp. Each timed with CUDA
   events beside its plain version and a library yardstick the port never
   calls (the einsum ``'align'`` ROI align; cuDNN conv2d + relu +
   max_pool2d), with its device time from ``torch.profiler``.
7. Phase 6: the detection path at full width: VGG-16 bf16, FC_DIM 4096, 21
   classes, ``POOLING_MODE='align_pallas'``, ``FUSE_CONV1``, seeded weights,
   the AZ net and the Fast R-CNN net joined by ``share_trunk``. With the
   ROI-align, conv1 and NMS launch counts reset just before and read just
   after: ``make_fused_detect_batch_padded`` on two raw 375x500 images,
   ``make_detect_batch_padded`` on its 300 proposals per image,
   ``im_propose`` and ``im_detect`` on one image. Checks the counts, the
   outputs (finite, softmax rows sum to 1, boxes inside the image), the
   fused program against the two-program path, both kernels against their
   plain versions on the path's own inputs, and the port on the card
   against the port on the CPU (VGG-16 at WIDTH 0.25). Prints detect img/s
   at b=2 from CUDA events after two warmups.

Prints the card's name and power limit, one JSON line of kernel records
(each with its bound and library yardstick), and, as the last line,
``{"ok": true, "device": {...}}``. Exits non-zero at the first failure and
when no CUDA device is present. Imports no JAX and nothing of ``aznet_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

NMS_SOURCE = "aznet_tpu_torch/csrc/nms.cu"
NMS_REPLACES = "aznet_tpu/ops/pallas/nms_kernel.py:336"
CONV_SOURCE = "aznet_tpu_torch/csrc/conv_int8.cu"
CHAIN_REPLACES = "aznet_tpu/ops/pallas/conv_int8_chain.py:217"
STRIP_REPLACES = "aznet_tpu/ops/pallas/conv_int8_kernel.py:87"
ROI_SOURCE = "aznet_tpu_torch/csrc/roi_align.cu"
ROI_REPLACES = "aznet_tpu/ops/pallas/roi_kernel.py:289"
CONV1_SOURCE = "aznet_tpu_torch/csrc/conv1_fused.cu"
CONV1_REPLACES = "aznet_tpu/ops/pallas/conv1_kernel.py:132"
BATCH = 2
RAW_HW = (375, 500)
CANVAS = (608, 800)
DETECT_ROIS = 300
# One H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W): device
# memory bytes/s and operations/s per type; "f32" is the rate outside the
# tensor cores, where the NMS and ROI-align kernels do their arithmetic.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
IOU_OPS = 15  # f32 operations per IoU of a box pair in the NMS mask pass


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


def device_us(fn, name, iters=20):
    """Mean device time in microseconds per call of ``fn`` of the kernels
    whose name holds ``name``, under ``torch.profiler``; None when the
    profiler saw no device time. Unlike :func:`cuda_ms` over back-to-back
    calls, it leaves out the host's launch overhead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages() if name in e.key)
    return total / iters if total else None


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
            b_ms, b_by = nms_bound(bsz, n)
            print(f"phase1 {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"kernel {bsz * n / k_ms / 1e3:.2f} Mboxes/s, bound {b_ms * 1e3:.3f} us "
                  f"({b_by})", flush=True)
    return err, times


def build_net(tag, cfg, dev, state_dict=None):
    import torch

    from aznet_tpu_torch import api

    t0 = time.perf_counter()
    net = api.build_az_net(cfg, state_dict=state_dict, device=dev)
    torch.cuda.synchronize()
    print(f"{tag} build_az_net: {time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in net.model.parameters())} params "
          f"({next(net.model.parameters()).dtype})", flush=True)
    return net


def phase2_propose(dev, net, tag="phase2", recorders=(), counters=()):
    """The propose path of ``net``. ``recorders`` are context managers that
    wrap other kernels of the path while it runs; ``counters`` are
    ``(name, reset, read)`` launch counters, reset just before the path
    and read just after. Returns (NMS launches, img/s, nms_err, {name: count},
    the preprocessed blobs of the two images)."""
    import torch

    from aznet_tpu_torch import api
    from aznet_tpu_torch.ops import nms as tnms
    from aznet_tpu_torch.ops.cuda import nms_kernel

    cfg, raw_hw, canvas = net.cfg, RAW_HW, CANVAS
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
        with contextlib.ExitStack() as stack:
            for rec in recorders:
                stack.enter_context(rec)
            for _, reset, _ in counters:
                reset()
            nms_kernel.LAUNCHES = 0
            boxes, scores, valid = fn(images)
            dets = api.im_propose(net, ims_np[0])
            torch.cuda.synchronize()
            launches = nms_kernel.LAUNCHES
            counts = {name: read() for name, _, read in counters}
    finally:
        nms_kernel.nms_cuda_batched = launch
    print(f"{tag} main path: nms launches {launches}"
          + "".join(f", {k} launches {v}" for k, v in counts.items()), flush=True)
    check(launches >= BATCH + 1, f"NMS kernel launched {launches} times, expected >= {BATCH + 1}")

    h, w = raw_hw
    check(boxes.shape == (BATCH, cfg.SEAR.NUM_PROPOSALS, 4), f"boxes shape {tuple(boxes.shape)}")
    for i in range(BATCH):
        n = int(valid[i].sum())
        check(1 <= n <= cfg.SEAR.NUM_PROPOSALS, f"image {i}: {n} proposals")
        b, s = boxes[i, :n].float(), scores[i, :n].float()
        print(f"{tag} image {i}: {n} proposals, top score {s[0].item():.6f}", flush=True)
        check(bool(torch.isfinite(b).all() and torch.isfinite(s).all()), f"image {i}: non-finite")
        check(bool((b >= 0).all() and (b[:, 0::2] <= w).all() and (b[:, 1::2] <= h).all()),
              f"image {i}: boxes outside the {h}x{w} image")
        check(bool((s[1:] <= s[:-1]).all()), f"image {i}: scores not sorted")
        check(not valid[i, n:].any(), f"image {i}: valid rows after the first invalid one")
    check(dets.ndim == 2 and dets.shape[1] == 5
          and 1 <= dets.shape[0] <= cfg.SEAR.NUM_PROPOSALS
          and np.isfinite(dets).all(), f"im_propose gave {dets.shape}")
    print(f"{tag} im_propose: {dets.shape[0]} proposals", flush=True)

    nms_err = 0.0
    for rb, rs, th, rv, off in recorded:
        got = tnms.nms_mask_batched(rb, rs, th, rv, off)
        want = tnms.nms_mask_reference(rb, rs, th, rv, off)
        nms_err = max(nms_err, (got.float() - want.float()).abs().max().item())
    print(f"{tag} NMS on the path's {len(recorded)} inputs ({tuple(recorded[0][1].shape)}): "
          f"kernel vs plain max_abs_err {nms_err}", flush=True)
    check(nms_err == 0.0, "NMS kernel disagrees with the plain version on the path's inputs")

    ms = cuda_ms(lambda: fn(images), 5, 2)
    blobs = torch.stack([api.preprocess_image(
        images[i], cfg.PIXEL_MEANS, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE, canvas[0],
        canvas[1], dtype=api._blob_dtype(cfg))[0] for i in range(BATCH)])
    breakdown(tag, net, blobs)
    torch.cuda.reset_peak_memory_stats()
    fn(images)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ips = BATCH / (ms / 1e3)
    print(f"{tag} make_propose_batch b={BATCH}: {ms:.3f} ms/call, {ips:.2f} img/s; "
          f"peak {peak:.2f} GiB", flush=True)
    return launches, ips, nms_err, counts, blobs


def breakdown(tag, net, blobs):
    """CUDA-event times of the path's parts at b=2: the trunk on the batch,
    one image's search, and one ``roi_forward`` at R=64."""
    import torch

    from aznet_tpu_torch import api
    from aznet_tpu_torch.search.propose import az_search

    cfg = net.cfg
    with torch.inference_mode():
        trunk_ms = cuda_ms(lambda: net.model.features(blobs), 5, 2)
        feat = api._maybe_quantize_feat(cfg, net.model.features(blobs))[0]
        valid_hw = (float(blobs.shape[1]), float(blobs.shape[2]))
        search_ms = cuda_ms(lambda: az_search(
            net.model.roi_forward, feat, valid_hw, cfg.SEAR,
            num_templates=cfg.MODEL.NUM_TEMPLATES, offset=cfg.BOX_OFFSET), 3, 1)
        rng = np.random.RandomState(3)
        xy = rng.uniform(0, 600, (64, 2)).astype(np.float32)
        rois = torch.from_numpy(np.concatenate(
            [xy, xy + rng.uniform(16, 200, (64, 2)).astype(np.float32)], 1)).to(feat.device)
        head_ms = cuda_ms(lambda: net.model.roi_forward(feat, rois), 10, 2)
        split = ""
        trunk = net.model.trunk
        if getattr(trunk, "int8_mode", False):
            codes = trunk.int8_prefix(blobs)
            split = (f" (bf16 prefix + quantize {cuda_ms(lambda: trunk.int8_prefix(blobs), 5, 2):.4f}"
                     f" ms, int8 layers {cuda_ms(lambda: trunk.int8_body(codes), 5, 2):.4f} ms)")
    print(f"{tag} breakdown: trunk {trunk_ms:.4f} ms per batch of {blobs.shape[0]}{split}, "
          f"az_search {search_ms:.4f} ms per image, roi_forward(R=64) {head_ms:.4f} ms "
          f"(feat {tuple(feat.shape)} {feat.dtype})", flush=True)


def phase2_reference(dev):
    """The port on the card against the port on the CPU, small f32 smallnet
    config, same seeded weights: proposals agree to 1e-4 (scores) and 1e-2
    pixels (boxes)."""
    import torch

    from aznet_tpu_torch.config import Config, cfg_from_dict
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


def main_path_int8_layers():
    """The int8 layers of the main path: (name, H, W, C, Co, pool, exit)
    from conv2_2 (input at stride 2) to conv5_3."""
    from aznet_tpu_torch.models.vgg import VGG16_LAYOUT

    names = [n for n, _ in VGG16_LAYOUT]
    h, w, c = CANVAS[0] // 2, CANVAS[1] // 2, 128
    out = []
    for i in range(names.index("conv2_2"), len(VGG16_LAYOUT)):
        name, co = VGG16_LAYOUT[i]
        if co is None:
            continue
        pool = i + 1 < len(VGG16_LAYOUT) and VGG16_LAYOUT[i + 1][1] is None
        out.append((name, h, w, c, co, pool, i == len(VGG16_LAYOUT) - 1))
        c = co
        if pool:
            h, w = h // 2, w // 2
    return out


def conv_case(seed, h, w, c, co, dev):
    """Post-ReLU-like int8 activations and a quantized random-normal layer."""
    import torch

    from aznet_tpu_torch.ops.conv_int8 import Int8Conv

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randint(0, 100, (BATCH, h, w, c), generator=g, device=dev, dtype=torch.int8)
    weight = torch.randn((co, c, 3, 3), generator=g, device=dev) * 0.02
    bias = torch.rand((co,), generator=g, device=dev) - 0.5
    return x, Int8Conv.from_float(weight, bias)


def phase3_conv(dev):
    """The int8 conv kernel alone at the main path's shapes. Returns
    {"err": {entry: max_abs_err}, "ms"/"plain_ms": {entry: summed over the
    main-path layers that entry runs}}."""
    import torch

    from aznet_tpu_torch.ops import conv_int8 as tconv

    s_x = 0.0419
    err = {"chain": 0.0, "strip": 0.0}
    ms = {"chain": 0.0, "strip": 0.0}
    plain_ms = {"chain": 0.0, "strip": 0.0}
    cases = [(*layer, True) for layer in main_path_int8_layers()]
    h0, w0 = cases[0][1:3]  # conv2_2's map: the strip entry there, and at C=64
    cases += [("conv2_2_nopool", h0, w0, 128, 128, False, False, False),
              ("c64_input", h0, w0, 64, 128, False, False, False)]
    for k, (name, h, w, c, co, pool, last, timed) in enumerate(cases):
        x, layer = conv_case(100 + k, h, w, c, co, dev)
        s_out = None if last else 0.3717 + 0.01 * k
        entry = "chain" if pool else "strip"
        run = lambda: tconv.conv3x3_int8(x, s_x, layer, s_out, pool=pool)
        plain = lambda: tconv.conv3x3_int8_reference(x, s_x, layer, s_out, pool=pool)
        got, want = run(), plain()
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{name}: kernel {got.dtype}{tuple(got.shape)} vs plain {want.dtype}{tuple(want.shape)}")
        diff = (got.float() - want.float()).abs().max().item()
        err[entry] = max(err[entry], diff)
        nz = (want != 0).float().mean().item()
        line = (f"phase3 {name} {entry} {BATCH}x{h}x{w}x{c}->{co}"
                f"{' pool' if pool else ''}{' bf16 exit' if last else ''}: "
                f"max_abs_err {diff}, nonzero {nz:.3f}, max |out| {want.float().abs().max().item()}")
        check(diff == 0.0, f"int8 conv kernel disagrees with the plain version at {name}")
        check(0.01 < nz, f"{name}: degenerate output")
        if timed:
            k_ms, p_ms = cuda_ms(run, 20, 3), cuda_ms(plain, 3, 1)
            ms[entry] += k_ms
            plain_ms[entry] += p_ms
            ops = 2.0 * BATCH * h * w * 9 * c * co
            line += (f"; kernel {k_ms:.4f} ms ({ops / k_ms / 1e9:.1f} TOP/s), "
                     f"plain {p_ms:.4f} ms")
        print(line, flush=True)
    print(f"phase3 per trunk call (b={BATCH}): chain {ms['chain']:.4f} ms vs plain "
          f"{plain_ms['chain']:.4f} ms, bound {int8_conv_bound('chain')[0]:.4f} ms; strip "
          f"{ms['strip']:.4f} ms vs plain {plain_ms['strip']:.4f} ms, bound "
          f"{int8_conv_bound('strip')[0]:.4f} ms (operations)", flush=True)
    return {"err": err, "ms": ms, "plain_ms": plain_ms}


@contextlib.contextmanager
def recording_conv(recorded):
    """Copies the arguments and the result of every conv kernel launch while
    active (the count is kept by the wrapper itself)."""
    from aznet_tpu_torch.ops.cuda import conv_int8_kernel as ck

    real = {"chain": ck.conv3x3_int8_chain, "strip": ck.conv3x3_int8_strip}

    def wrap(entry):
        def call(x, s_x, w_k, s_w, bias, s_out, *rest):
            out = real[entry](x, s_x, w_k, s_w, bias, s_out, *rest)
            recorded.append((entry, x.clone(), s_x, w_k, s_w, bias, s_out, out.clone()))
            return out
        return call

    ck.conv3x3_int8_chain, ck.conv3x3_int8_strip = wrap("chain"), wrap("strip")
    try:
        yield
    finally:
        ck.conv3x3_int8_chain, ck.conv3x3_int8_strip = real["chain"], real["strip"]


def phase4_int8(dev, net, blobs, bf16_ips):
    """Calibrate the bf16 ``net``, rebuild it int8 from its float32
    parameters, drive the int8 propose path. Returns launches per entry,
    the conv and NMS errors on the path's inputs, and img/s."""
    import dataclasses

    import torch

    from aznet_tpu_torch.ops import conv_int8 as tconv
    from aznet_tpu_torch.ops.cuda import conv_int8_kernel as ck
    from aznet_tpu_torch.ops.quant import (calibrate_head_int8, calibrate_trunk_int8,
                                           with_int8_scales)

    cfg = net.cfg
    t0 = time.perf_counter()
    calib = np.random.RandomState(7).randint(0, 256, (2,) + CANVAS + (3,)).astype(np.float32)
    calib -= np.asarray(cfg.PIXEL_MEANS, np.float32)
    scales = calibrate_trunk_int8(net, calib, batch_size=2)
    head_scales = calibrate_head_int8(net, calib, scales)
    torch.cuda.synchronize()
    print(f"phase4 calibration: {time.perf_counter() - t0:.2f} s; trunk scales "
          f"{[round(s, 6) for s in scales]}, head scales {[round(s, 6) for s in head_scales]}",
          flush=True)
    cfg8 = with_int8_scales(cfg, scales, head_scales)
    cfg8 = dataclasses.replace(cfg8, MODEL=dataclasses.replace(cfg8.MODEL, INT8_ROI=True))
    net8 = build_net("phase4", cfg8, dev, state_dict=net.params)

    def reset():
        ck.LAUNCHES["chain"] = ck.LAUNCHES["strip"] = 0

    recorded = []
    counters = [(e, reset, lambda e=e: ck.LAUNCHES[e]) for e in ("chain", "strip")]
    nms_launches, ips, nms_err, counts, _ = phase2_propose(
        dev, net8, "phase4", recorders=[recording_conv(recorded)], counters=counters)
    trunk_calls = 2  # make_propose_batch on the batch, then im_propose
    check(counts["chain"] + counts["strip"] >= 10 * trunk_calls,
          f"int8 conv kernel launched {counts} times in {trunk_calls} trunk calls")
    check(counts["chain"] > 0 and counts["strip"] > 0, f"an int8 conv entry never ran: {counts}")
    check(nms_launches >= BATCH + 1, f"NMS launched {nms_launches} times")

    conv_err = {"chain": 0.0, "strip": 0.0}
    for entry, x, s_x, w_k, s_w, bias, s_out, out in recorded:
        want = tconv.conv3x3_int8_reference(x, s_x, tconv.Int8Conv(w_k, s_w, bias), s_out,
                                            pool=entry == "chain")
        conv_err[entry] = max(conv_err[entry], (out.float() - want.float()).abs().max().item())
    shapes = sorted({(e, tuple(x.shape)) for e, x, *_ in recorded})
    print(f"phase4 conv on the path's {len(recorded)} inputs {shapes}: kernel vs plain "
          f"max_abs_err {conv_err}", flush=True)
    check(max(conv_err.values()) == 0.0,
          "int8 conv kernel disagrees with the plain version on the path's inputs")

    with torch.inference_mode():
        f16 = net.model.features(blobs).float()
        f8 = net8.model.features(blobs).float()
    cos = (f16 * f8).sum().item() / max(f16.norm().item() * f8.norm().item(), 1e-9)
    print(f"phase4 int8 vs bf16 trunk features: cosine {cos:.6f}", flush=True)
    check(cos > 0.98, f"int8 trunk features drift from the bf16 trunk: cosine {cos}")
    print(f"phase4 img/s at b={BATCH}: int8 {ips:.2f} vs bf16 {bf16_ips:.2f} (same call)",
          flush=True)
    return {"launches": counts, "conv_err": conv_err, "nms_err": nms_err, "ips": ips}


def phase4_reference(dev):
    """The int8 port on the card against the port on the CPU: VGG-16 at WIDTH
    0.125 (the strip entry), fixed scales, seeded weights. The int8 codes
    that enter conv2_2 may differ where the two devices' float convs of the
    bf16 prefix round a value at a quantization boundary (<= 1 code on
    <= 0.1%); from the same codes the int8 layers agree bit for bit."""
    import torch

    from aznet_tpu_torch.config import Config, cfg_from_dict
    from aznet_tpu_torch import api
    from aznet_tpu_torch.ops.cuda import conv_int8_kernel as ck
    from aznet_tpu_torch.ops.quant import with_int8_scales

    cfg = cfg_from_dict(Config(), {"MODEL": {"WIDTH": 0.125, "FC_DIM": 64}})
    cfg = with_int8_scales(cfg, [2.0, 1.5, 1.2, 0.8, 0.6, 0.4, 0.3, 0.2, 0.15, 0.1,
                                 0.08, 0.06, 0.05])
    cpu_net = api.build_az_net(cfg, device="cpu")
    gpu_net = api.build_az_net(cfg, state_dict=cpu_net.params, device=dev)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.uniform(-120, 120, (2, 96, 128, 3)).astype(np.float32))
    with torch.inference_mode():
        codes_cpu = cpu_net.model.trunk.int8_prefix(x)
        codes_gpu = gpu_net.model.trunk.int8_prefix(x.to(dev))
        before = dict(ck.LAUNCHES)
        got = gpu_net.model.trunk.int8_body(codes_gpu).cpu()
        launched = {e: ck.LAUNCHES[e] - before[e] for e in before}
        want = cpu_net.model.trunk.int8_body(codes_gpu.cpu())
        full_gpu = gpu_net.model.features(x.to(dev)).float().cpu()
        full_cpu = cpu_net.model.features(x).float()
    d = (codes_gpu.cpu().int() - codes_cpu.int()).abs()
    frac = (d > 0).float().mean().item()
    body_err = (got.float() - want.float()).abs().max().item()
    rel = ((full_gpu - full_cpu).abs().max() / full_cpu.abs().max()).item()
    print(f"phase4 reference (int8 VGG-16 WIDTH 0.125, card vs CPU): prefix codes differ "
          f"on {frac:.2e} (max {d.max().item()}), trunk body from the same codes max_abs_err "
          f"{body_err} ({launched}), whole trunk max rel err {rel:.3g}", flush=True)
    check(d.max().item() <= 1 and frac <= 1e-3, "card and CPU int8 prefix codes disagree")
    check(body_err == 0.0 and launched["strip"] == 10 and launched["chain"] == 0,
          "card and CPU int8 trunk bodies disagree (or the strip entry did not run)")
    check(rel <= 2e-2, "card and CPU int8 trunks disagree")


def bound(nbytes, ops, peak):
    """(bound_ms, bound_by): the larger of the bytes over the card's memory
    rate and the operations over its peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nms_bound(bsz, n):
    """Boxes, scores and valid flags read once, keep flags written once; the
    IoU of every pair of a stream."""
    return bound(bsz * n * (16 + 4 + 1 + 1), bsz * n * (n - 1) // 2 * IOU_OPS, "f32")


def int8_conv_bound(entry):
    """Summed over the main-path layers the entry runs (b=2): int8 input,
    int8 weights, scales and bias read once, the output written once."""
    ms = 0.0
    for _, h, w, c, co, pool, last in main_path_int8_layers():
        if pool != (entry == "chain"):
            continue
        out_px = BATCH * h * w // (4 if pool else 1)
        nbytes = BATCH * h * w * c + 9 * c * co + 8 * co + out_px * co * (2 if last else 1)
        ms += bound(nbytes, 2.0 * BATCH * h * w * 9 * c * co, "int8")[0]
    return ms, "operations"


def roi_bound(feat, rois, w_first):
    """The feature cells the rois' taps touch, the rois and the output, each
    moved once; two f32 operations per channel for every tap of the two
    contractions that this run's rois have (zero-weight slots excluded)."""
    import torch

    from aznet_tpu_torch.ops import roi_pool as troi

    h, w, c = feat.shape
    scaled = rois.float() * (1.0 / 16)
    cells, live = [], []
    for lo, hi, extent in ((1, 3, h), (0, 2, w)):
        cl, wt = troi.fused_taps(scaled[:, lo], (scaled[:, hi] - scaled[:, lo]).clamp(min=1.0),
                                 extent, 7)
        cells.append(cl.reshape(len(rois), -1))
        live.append((wt.to(feat.dtype) != 0).reshape(len(rois), -1))
    touched = torch.zeros(h * w, dtype=torch.bool, device=feat.device)
    idx = cells[0][:, :, None] * w + cells[1][:, None, :]
    touched[idx[live[0][:, :, None] & live[1][:, None, :]]] = True
    n_y, n_x = (m.reshape(len(rois), 7, 4).sum(-1).float() for m in live)
    n_f, n_s = (n_x, n_y) if w_first else (n_y, n_x)
    ops = 2.0 * c * float((n_s.sum(1) * (n_f.sum(1) + 7)).sum())
    item = feat.element_size()
    nbytes = int(touched.sum()) * c * item + rois.numel() * 4 + len(rois) * 49 * c * item
    return bound(nbytes, ops, "f32")


def detect_rois(n, seed, dev):
    """``n`` boxes on the 608x800 canvas: corners uniform, sides log-uniform
    in [16, 600] pixels, clipped to the canvas (the search's scaled boxes)."""
    import torch

    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, (CANVAS[1] - 16, CANVAS[0] - 16), (n, 2))
    wh = np.exp(rng.uniform(np.log(16), np.log(600), (n, 2)))
    xy2 = np.minimum(xy + wh, (CANVAS[1] - 1, CANVAS[0] - 1))
    return torch.from_numpy(np.concatenate([xy, xy2], 1).astype(np.float32)).to(dev)


def phase5_kernels(dev):
    """The ROI-align and fused conv1 kernels alone at the slice's shapes,
    against their plain versions and a library yardstick the port never
    calls. Returns {kernel: {"err", "ms", "plain_ms", "library_ms",
    "bound"}}."""
    import torch
    import torch.nn.functional as F

    from aznet_tpu_torch.ops import conv1_fused as tconv1
    from aznet_tpu_torch.ops import roi_pool as troi
    from aznet_tpu_torch.ops.cuda import conv1_kernel, roi_align_kernel

    h, w, c = CANVAS[0] // 16, CANVAS[1] // 16, 512
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    base = torch.relu(torch.randn((h, w, c), generator=g, device=dev)) * 20
    out = {}
    roi = {"err": 0.0}
    for dtype, r in ((torch.bfloat16, 8), (torch.bfloat16, 64), (torch.bfloat16, DETECT_ROIS),
                     (torch.float32, 64)):
        feat = base.to(dtype)
        rois = detect_rois(r, r, dev)
        wf = troi.fused_w_first(h, w, c, feat.element_size())
        got = roi_align_kernel.roi_align_cuda(feat, rois, 1 / 16.0, 7, wf)
        want = troi.roi_align_fused_reference(feat, rois, 1 / 16.0, 7, wf)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        roi["err"] = max(roi["err"], err)
        k_ms = cuda_ms(lambda: roi_align_kernel.roi_align_cuda(feat, rois, 1 / 16.0, 7, wf), 50, 3)
        p_ms = cuda_ms(lambda: troi.roi_align_fused_reference(feat, rois, 1 / 16.0, 7, wf), 5, 1)
        l_ms = cuda_ms(lambda: troi.roi_align(feat, rois, 1 / 16.0, 7), 20, 2)
        dev_us = device_us(lambda: roi_align_kernel.roi_align_cuda(feat, rois, 1 / 16.0, 7, wf),
                           "roi_align_kernel")
        b_ms, b_by = roi_bound(feat, rois, wf)
        name = f"{str(dtype)[6:]} {h}x{w}x{c} R={r} {'W' if wf else 'H'}-first"
        print(f"phase5 roi_align {name}: max_abs_err {err}, max |out| "
              f"{want.float().abs().max().item()}; kernel {k_ms:.4f} ms per call "
              f"(device time {dev_us} us), plain {p_ms:.4f} ms, library (einsum 'align') "
              f"{l_ms:.4f} ms, bound {b_ms * 1e3:.3f} us ({b_by})", flush=True)
        check(err == 0.0, f"ROI-align kernel disagrees with the plain version at {name}")
        check(wf == (dtype == torch.float32), f"{name}: the order rule picked the other order")
        if dtype == torch.bfloat16 and r == DETECT_ROIS:  # the record: the detect head's shape
            roi.update(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound=(b_ms, b_by))
    out["roi"] = roi

    y = (torch.relu(torch.randn((BATCH,) + CANVAS + (64,), generator=g, device=dev)) * 30
         ).to(torch.bfloat16)
    w12 = (torch.randn((64, 64, 3, 3), generator=g, device=dev) * 0.06).to(torch.bfloat16)
    b12 = (torch.rand((64,), generator=g, device=dev) - 0.5).to(torch.bfloat16)
    w9, bias = tconv1.kernel_weights(w12), b12.float()
    got = conv1_kernel.conv1_2_pool_cuda(y, w9, bias)
    want = tconv1.conv1_2_pool_reference(y, w12, b12)
    torch.cuda.synchronize()
    ok, frac = tconv1.within_one_bf16_ulp(got, want)
    err = (got.float() - want.float()).abs().max().item()
    y_nchw, w_cl = y.permute(0, 3, 1, 2), w12.contiguous(memory_format=torch.channels_last)

    def library():
        return F.max_pool2d(torch.relu(F.conv2d(y_nchw, w_cl, b12, padding=1)), 2)

    k_ms = cuda_ms(lambda: conv1_kernel.conv1_2_pool_cuda(y, w9, bias), 20, 3)
    p_ms = cuda_ms(lambda: tconv1.conv1_2_pool_reference(y, w12, b12), 3, 1)
    l_ms = cuda_ms(library, 20, 3)
    dev_us = device_us(lambda: conv1_kernel.conv1_2_pool_cuda(y, w9, bias), "conv1_fused_kernel")
    ops = 2.0 * BATCH * CANVAS[0] * CANVAS[1] * 9 * 64 * 64
    nbytes = y.numel() * 2 + w12.numel() * 2 + 64 * 4 + got.numel() * 2
    b_ms, b_by = bound(nbytes, ops, "bf16")
    print(f"phase5 conv1_fused {BATCH}x{CANVAS[0]}x{CANVAS[1]}x64 bf16: max_abs_err {err}, "
          f"within one bf16 ulp {ok}, {frac:.4%} of elements differ, max |out| "
          f"{want.float().abs().max().item()}; kernel {k_ms:.4f} ms ({ops / k_ms / 1e9:.1f} "
          f"TFLOP/s; device time {dev_us} us), plain {p_ms:.4f} ms, library (cuDNN conv2d "
          f"+ relu + max_pool2d) {l_ms:.4f} ms, bound {b_ms * 1e3:.2f} us ({b_by})", flush=True)
    check(ok, "conv1 kernel is more than one bf16 ulp from the plain version")
    out["conv1"] = {"err": err, "frac": frac, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                    "bound": (b_ms, b_by)}
    return out


@contextlib.contextmanager
def recording_detect_kernels(recorded):
    """Copies the arguments and results of every ROI-align and conv1 kernel
    launch while active (the counts are kept by the wrappers themselves)."""
    from aznet_tpu_torch.ops.cuda import conv1_kernel, roi_align_kernel

    real_roi, real_conv1 = roi_align_kernel.roi_align_cuda, conv1_kernel.conv1_2_pool_cuda

    def roi(feat, rois, scale, pool, w_first):
        out = real_roi(feat, rois, scale, pool, w_first)
        recorded.append(("roi", (feat, rois.clone(), scale, pool, w_first), out))
        return out

    def conv1(y, w9, bias):
        out = real_conv1(y, w9, bias)
        recorded.append(("conv1", (y, w9, bias), out))
        return out

    roi_align_kernel.roi_align_cuda, conv1_kernel.conv1_2_pool_cuda = roi, conv1
    try:
        yield
    finally:
        roi_align_kernel.roi_align_cuda, conv1_kernel.conv1_2_pool_cuda = real_roi, real_conv1


def detect_config():
    """VGG-16 bf16 at full width (FC_DIM 4096, 21 classes) with the
    reference's fused options: every ROI pool through the fused ROI align,
    conv1_2 + ReLU + pool1 through the fused conv1."""
    from aznet_tpu_torch.config import Config, cfg_from_dict

    return cfg_from_dict(Config(), {"MODEL": {"POOLING_MODE": "align_pallas",
                                              "FUSE_CONV1": True}})


def check_detections(tag, scores, boxes, hw, n_classes):
    import torch

    h, w = hw
    check(scores.ndim == 2 and scores.shape[1] == n_classes and boxes.shape
          == (scores.shape[0], 4 * n_classes), f"{tag}: scores {tuple(scores.shape)}, "
          f"boxes {tuple(boxes.shape)}")
    s, b = torch.as_tensor(scores).float(), torch.as_tensor(boxes).float()
    check(bool(torch.isfinite(s).all() and torch.isfinite(b).all()), f"{tag}: non-finite")
    check(float((s.sum(-1) - 1).abs().max()) <= 1e-5, f"{tag}: softmax rows do not sum to 1")
    check(bool((b >= 0).all() and (b[:, 0::2] <= w - 1).all() and (b[:, 1::2] <= h - 1).all()),
          f"{tag}: boxes outside the {h}x{w} image")


def phase6_detect(dev):
    """The detection path at full width: make_fused_detect_batch_padded,
    make_detect_batch_padded on the fused run's proposals, im_propose and
    im_detect, with the ROI-align, conv1 and NMS launch counts reset just
    before and read just after. Returns the counts, the kernels' errors on
    the path's inputs, and img/s."""
    import torch

    from aznet_tpu_torch import api
    from aznet_tpu_torch.ops import conv1_fused as tconv1
    from aznet_tpu_torch.ops import roi_pool as troi
    from aznet_tpu_torch.ops.cuda import conv1_kernel, nms_kernel, roi_align_kernel

    cfg = detect_config()
    t0 = time.perf_counter()
    az = api.build_az_net(cfg, device=dev)
    fr = api.share_trunk(api.build_frcnn_net(cfg, device=dev, seed=cfg.RNG_SEED + 1), az)
    torch.cuda.synchronize()
    check(api.trunks_shared(az, fr), "share_trunk left the trunks apart")
    print(f"phase6 build_az_net + build_frcnn_net + share_trunk: {time.perf_counter() - t0:.2f} s",
          flush=True)
    n_cls = cfg.MODEL.NUM_CLASSES
    h, w = RAW_HW
    ims_np = np.random.RandomState(0).randint(0, 256, (BATCH,) + RAW_HW + (3,)).astype(np.uint8)
    images = torch.from_numpy(ims_np).to(dev)
    src_hw = torch.tensor([RAW_HW] * BATCH, dtype=torch.float32, device=dev)
    scales = torch.tensor([api.compute_scale(h, w, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE)]
                          * BATCH, dtype=torch.float32, device=dev)
    fused = api.make_fused_detect_batch_padded(az.model, fr.model, cfg, cfg, CANVAS)
    detect = api.make_detect_batch_padded(fr.model, cfg, CANVAS)

    recorded = []
    with recording_detect_kernels(recorded):
        roi_align_kernel.LAUNCHES = conv1_kernel.LAUNCHES = nms_kernel.LAUNCHES = 0
        p_boxes, p_scores, p_valid, d_scores, d_boxes = fused(images, src_hw, scales)
        t_scores, t_boxes = detect(images, src_hw, scales, p_boxes)
        props = api.im_propose(az, ims_np[0])
        s1, b1 = api.im_detect(fr, ims_np[0], props)
        torch.cuda.synchronize()
        counts = {"roi_align": roi_align_kernel.LAUNCHES, "conv1": conv1_kernel.LAUNCHES,
                  "nms": nms_kernel.LAUNCHES}
    print(f"phase6 main path: launches {counts}", flush=True)
    n_iter = max(int(cfg.TEST.BBOX_ITER), 1)
    searches, detects, trunk_calls = BATCH + 1, 2 * BATCH + 1, 4
    check(counts["conv1"] == trunk_calls, f"conv1 kernel launched {counts['conv1']} times in "
          f"{trunk_calls} trunk calls")
    check(counts["roi_align"] >= searches + n_iter * detects,
          f"ROI-align kernel launched {counts['roi_align']} times")
    check(counts["nms"] >= searches, f"NMS kernel launched {counts['nms']} times")

    for i in range(BATCH):
        n = int(p_valid[i].sum())
        check(1 <= n <= cfg.SEAR.NUM_PROPOSALS, f"image {i}: {n} proposals")
        check(bool(torch.isfinite(p_boxes[i]).all() and torch.isfinite(p_scores[i]).all()),
              f"image {i}: non-finite proposals")
        check_detections(f"fused image {i}", d_scores[i], d_boxes[i], RAW_HW, n_cls)
        check_detections(f"detect batch image {i}", t_scores[i], t_boxes[i], RAW_HW, n_cls)
        print(f"phase6 image {i}: {n} proposals, top proposal score "
              f"{p_scores[i, 0].item():.6f}, top class score "
              f"{d_scores[i, :n, 1:].max().item():.6f}", flush=True)
    check_detections("im_detect", s1, b1, RAW_HW, n_cls)
    check(s1.shape[0] == props.shape[0] >= 1, f"im_detect gave {s1.shape} for {props.shape}")
    d_s = (d_scores - t_scores).abs().max().item()
    d_b = ((d_boxes - t_boxes).abs().max() / t_boxes.abs().max()).item()
    print(f"phase6 fused vs two-program (same proposals): max |d score| {d_s:.3g}, "
          f"max |d box| / max |box| {d_b:.3g}", flush=True)
    check(d_s <= 1e-2 and d_b <= 1e-2, "the fused program disagrees with the two-program path")

    errs = {"roi": 0.0, "conv1": 0.0}
    frac = 0.0
    for kind, args, out in recorded:
        if kind == "roi":
            feat, rois, scale, pool, w_first = args
            want = troi.roi_align_fused_reference(feat, rois, scale, pool, w_first)
            errs["roi"] = max(errs["roi"], (out.float() - want.float()).abs().max().item())
        else:
            y, w9, bias = args
            w12 = w9.reshape(3, 3, w9.shape[1], w9.shape[2]).permute(2, 3, 0, 1)
            want = tconv1.conv1_2_pool_reference(y, w12, bias)
            ok, f = tconv1.within_one_bf16_ulp(out, want)
            check(ok, "conv1 kernel is more than one bf16 ulp from the plain version on the "
                      "path's inputs")
            frac = max(frac, f)
            errs["conv1"] = max(errs["conv1"], (out.float() - want.float()).abs().max().item())
    rs = sorted({int(a[1].shape[0]) for k, a, _ in recorded if k == "roi"})
    print(f"phase6 kernels on the path's inputs: ROI align ({counts['roi_align']} launches, R in "
          f"{rs}) max_abs_err {errs['roi']}; conv1 ({counts['conv1']} launches) max_abs_err "
          f"{errs['conv1']}, within one bf16 ulp, at most {frac:.4%} of elements differ",
          flush=True)
    check(errs["roi"] == 0.0, "ROI-align kernel disagrees with the plain version on the path's "
                              "inputs")
    recorded.clear()

    fused_ms = cuda_ms(lambda: fused(images, src_hw, scales), 5, 2)
    detect_ms = cuda_ms(lambda: detect(images, src_hw, scales, p_boxes), 5, 2)
    blobs = torch.stack([api.preprocess_image(
        images[i], cfg.PIXEL_MEANS, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE, CANVAS[0], CANVAS[1],
        dtype=torch.bfloat16)[0] for i in range(BATCH)])
    trunk = az.model.trunk
    with torch.inference_mode():
        fused_trunk_ms = cuda_ms(lambda: trunk(blobs), 5, 2)
        trunk.fuse_conv1 = False
        plain_trunk_ms = cuda_ms(lambda: trunk(blobs), 5, 2)
        trunk.fuse_conv1 = True
        feat = trunk(blobs)[0]
        head_ms = cuda_ms(lambda: fr.model.roi_forward(feat, p_boxes[0] * scales[0]), 10, 2)
    print(f"phase6 breakdown: trunk {fused_trunk_ms:.4f} ms per batch of {BATCH} with "
          f"FUSE_CONV1 vs {plain_trunk_ms:.4f} ms without; FRCNN roi_forward (R="
          f"{p_boxes.shape[1]}) {head_ms:.4f} ms", flush=True)
    ips = BATCH / (fused_ms / 1e3)
    print(f"phase6 make_fused_detect_batch_padded b={BATCH}: {fused_ms:.3f} ms/call, {ips:.2f} "
          f"img/s; make_detect_batch_padded (R={p_boxes.shape[1]}): {detect_ms:.3f} ms/call, "
          f"{BATCH / (detect_ms / 1e3):.2f} img/s", flush=True)
    return {"launches": counts, "err": errs, "ips": ips}


def phase6_reference(dev):
    """The detection port on the card against the port on the CPU: VGG-16 at
    WIDTH 0.25 (conv1 C=16), bf16, FC_DIM 64, the same flags, seeded weights;
    im_detect on the same 40 boxes. bf16 trunks round differently on the two
    devices (cuDNN vs the CPU's convolutions): scores to 1e-2, boxes to 0.5
    pixel."""
    import dataclasses

    from aznet_tpu_torch import api
    from aznet_tpu_torch.ops.cuda import conv1_kernel, roi_align_kernel

    cfg = detect_config()
    cfg = dataclasses.replace(cfg, MODEL=dataclasses.replace(cfg.MODEL, WIDTH=0.25, FC_DIM=64),
                              TEST=dataclasses.replace(cfg.TEST, SCALES=(64,), MAX_SIZE=128))
    cpu_net = api.build_frcnn_net(cfg, device="cpu")
    gpu_net = api.build_frcnn_net(cfg, state_dict=cpu_net.params, device=dev)
    rng = np.random.RandomState(1)
    im = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    xy = rng.uniform(0, 80, (40, 2))
    boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(8, 60, (40, 2)), 120)], 1)
    boxes = boxes.astype(np.float32)
    before = (roi_align_kernel.LAUNCHES, conv1_kernel.LAUNCHES)
    got = api.im_detect(gpu_net, im, boxes)
    launched = (roi_align_kernel.LAUNCHES - before[0], conv1_kernel.LAUNCHES - before[1])
    want = api.im_detect(cpu_net, im, boxes)
    d_s = float(np.abs(got[0] - want[0]).max())
    d_b = float(np.abs(got[1] - want[1]).max())
    print(f"phase6 reference (VGG-16 WIDTH 0.25 bf16, card vs CPU): max |d score| {d_s:.3g}, "
          f"max |d box| {d_b:.3g}; launches (roi_align, conv1) {launched}", flush=True)
    check(launched == (1, 1), f"the small config did not run both kernels: {launched}")
    check(d_s <= 1e-2 and d_b <= 0.5, "card and CPU detections disagree")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from aznet_tpu_torch import _build
    from aznet_tpu_torch.config import Config

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
    net = build_net("phase2", Config(), dev)
    launches, ips, err2, _, blobs = phase2_propose(dev, net)
    phase2_reference(dev)

    conv = phase3_conv(dev)
    int8 = phase4_int8(dev, net, blobs, ips)
    phase4_reference(dev)
    del net
    torch.cuda.empty_cache()

    new = phase5_kernels(dev)
    det = phase6_detect(dev)
    phase6_reference(dev)

    k_ms, p_ms = times["path_1x2048"]
    nms_b = nms_bound(1, 2048)
    records = [{
        "name": "nms_exact_greedy", "route": "cuda", "source": NMS_SOURCE,
        "replaces": NMS_REPLACES, "launches": launches,
        "max_abs_err": max(err1, err2, int8["nms_err"]), "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": nms_b[0], "bound_by": nms_b[1], "library_ms": None}]
    for entry, replaces in (("chain", CHAIN_REPLACES), ("strip", STRIP_REPLACES)):
        b_ms, b_by = int8_conv_bound(entry)
        records.append({
            "name": f"conv3x3_int8_{entry}", "route": "cuda", "source": CONV_SOURCE,
            "replaces": replaces, "launches": int8["launches"][entry],
            "max_abs_err": max(conv["err"][entry], int8["conv_err"][entry]),
            "ms": conv["ms"][entry], "plain_ms": conv["plain_ms"][entry],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    for key, name, source, replaces in (
            ("roi", "roi_align_fused", ROI_SOURCE, ROI_REPLACES),
            ("conv1", "conv1_fused_pool", CONV1_SOURCE, CONV1_REPLACES)):
        rec = new[key]
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": det["launches"]["roi_align" if key == "roi" else "conv1"],
            "max_abs_err": max(rec["err"], det["err"][key]), "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound"][0],
            "bound_by": rec["bound"][1], "library_ms": rec["library_ms"]})
    print(json.dumps({"kernels": records}))
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
