#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``aznet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card and nvcc

1. Builds the CUDA kernels from ``aznet_tpu_torch/csrc`` (into the
   git-ignored ``build/``): NMS, the int8 conv, ROI align, fused conv1
   (bf16 and float32), IoU, the search level, the frozen BatchNorm
   epilogue.
2. Phase 1: holds the kernel's keep masks against its plain PyTorch version
   on the card, bit for bit: the search's shape (1 x 2048, IoU 0.7), the
   16 x 4096 stream shape (boxes uniform in [0, 2000] plus wh in [5, 300],
   IoU 0.5, seed 3), and tie-heavy streams with +-0, subnormal and invalid
   rows. Times both with CUDA events after warmup, and the kernel's three
   passes (sort, mask, scan) on the device with ``torch.profiler``.
3. Phase 2: the bf16 VGG-16 propose path at full width (seeded random
   weights), ``make_propose_batch`` on two raw 375x500 uint8 images on a
   608x800 canvas and one ``im_propose`` call, with the NMS launch count
   reset just before and read just after; checks the proposals, holds
   every kernel launch of that run against its plain version, and holds
   the port on the card against the port on the CPU on a small f32
   smallnet config. Prints img/s from CUDA events after two warmups.
   Every card-vs-CPU check runs under PyTorch's default precision flags (the
   port scopes its own float32 precision, ``utils/precision.py``). Then
   two precision probes: which TF32 settings (the legacy ``allow_tf32``
   flags, the newer ``fp32_precision``) the card's float32 convolution and
   matmul honour, what reading the other API does after setting one, and
   that the port's scope gives float32 under a caller's TF32 set through
   either API; and fc6 at full width (300 x 25,088 x 4,096 bf16) with
   ``allow_bf16_reduced_precision_reduction`` True and False against an f32
   product of the same operands, each timed.
4. Phase 3: the int8 conv kernel alone (``aznet_tpu_torch/csrc/conv_int8.cu``)
   at the 10 int8 layer shapes of the main path (b=2, 608x800 canvas:
   conv2_2 .. conv5_3), non-power-of-two scales: the chain entry (fused pool)
   where a pool follows, the strip entry elsewhere; plus the strip entry at
   conv2_2's shape without the pool and at a C=64 input. Kernel equals plain
   bit for bit (int8 codes, bf16 exit). Per layer: the tile chosen, the
   kernel's device time (``torch.profiler``) and TOP/s beside its CUDA-event
   time, the plain version's time, and ``torch._int_mm`` at the layer's
   implicit-GEMM shape (M = B*H*W, K = 9*C, N = Co) on an im2col matrix
   built outside the timed region: the int8 GEMM core alone, no im2col, no
   epilogue, a yardstick the port never calls (``library_ms``).
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
   38x50x512 trunk map of a 608x800 canvas: bf16 at R = 8, 32, 64 and 300
   (H-first by the order rule) and f32 at R = 64 (W-first), and on
   ResNet-50's 68x120x1024 map of a 1088x1920 canvas (bf16, W-first) at R =
   8, 32 and 128, bit for bit against its plain version; the fused conv1
   kernel (``csrc/conv1_fused.cu``) at b=2, 608x800x64 bf16, within one bf16
   ulp. Each timed with CUDA events beside its plain version and a library
   yardstick the port never calls (the einsum ``'align'`` ROI align; cuDNN
   conv2d + relu + max_pool2d, and cuDNN's conv2d alone), with its device
   time from ``torch.profiler`` (ROI align also with the host's time per
   call); conv1 also as TFLOP/s and a share of the bf16 peak.
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
8. Phase 7: the tiled IoU kernel (``csrc/iou.cu``) alone, as the JAX
   package holds ``bbox_overlaps_pallas`` alone (no path calls either), bit
   for bit against its plain version (``ops/iou.py::bbox_overlaps``) at
   offsets 1 and 0 at 300x200, 50x40, 128x128, 200x300, 2048x2048,
   4096x4096, ragged K (300x201, 50x41, 129x130, 2047x2049, 4096x4095),
   1x1, 1x4096 and 2,100,000x3 (above the old grid's row cap), with
   degenerate, zero-area and union <= 0 boxes; each timed (device,
   CUDA-event and host time) beside the plain version, its bound and the
   device time of ``zero_()`` on an ``[N, K]`` float32 tensor, a yardstick
   of the card's write rate that computes no IoU. Phase 1 also runs the NMS
   kernel on score-sorted 16 x 4096 input (the input of
   ``tools/bench_nms_variants.py``'s kernel-only launch) and at ResNet-50's
   1 x 4096.
9. Phase 8: ResNet-50 at 1080p (``experiments/cfgs/resnet50_1080p.yml``,
   ``POOLING_MODE='align_pallas'``): two raw 1080x1920 images on a
   1088x1920 canvas, bf16, then int8 calibrated on two random canvases at
   batch 1 with ``INT8_ROI``; the NMS and ROI-align launch counts reset just
   before each main path and read just after, both kernels held on the
   path's own inputs (the W-first bf16 order at C=1024); img/s, trunk and
   search times. Then the int8 net with the einsum ``'align'`` once (the
   int8 ROI align on the 68x120 map), the einsum ROI align on that map on
   the card against the CPU, and ResNet-50 on the card against the CPU at a
   small image (f32, and the int8 trunk). Phase 8b: the ResNet-101 C4
   detector (``resnet101_c4``, the ``resnet101_c4.detect_given_b8`` cell's
   settings: bf16, ROI align to 14 through the kernel, 21 classes, seeded
   weights): one ``make_detect_batch`` call of 8 raw 375x500 images with 300
   boxes each on the 608x800 canvas, every launch count set to 0 just
   before and read just after (163 frozen BatchNorm launches: the trunk's
   91, 9 a head call; 8 ROI-align launches at pool 14 on the 38x50x1024
   map, nothing else), every launch held against its plain version, the
   detections checked; ms a call. Phase 8c: the R-101-FPN detector
   (``resnet101_fpn``, the ``resnet101_fpn.detect_coco_b4`` cell's
   settings: bf16, ROI align to 7 over P2-P5, fc6 and fc7 of 1024, 81
   classes, seeded weights): one ``make_detect_batch`` call of 4 raw
   480x640 images with 1000 boxes each on every level on the 800x1088
   canvas, the counts set to 0 just before and read just after (100 frozen
   BatchNorm launches, 4 levels launches, nothing else), every launch held
   against its plain version, the detections checked; ms a call; then the
   levels kernel alone on the call's first image beside its plain version,
   the einsum ``'align'`` a level and its bound summed over the levels (the
   ``kernels`` line's ``roi_align_levels`` record).
10. Phase 9: CaffeNet and VGG_CNN_M_1024 from their config files, bf16,
   ``'align_pallas'`` (the ROI-align kernel at P=6), two raw 375x500 images
   on a 608x800 canvas, as phase 8; each on the card against the CPU at a
   small image.

11. Phase 10: dataset-level evaluation (``aznet_tpu_torch.eval``) on the
   first 16 images of ``synthetic_hard_test`` (375x500 on the drivers'
   640x832 canvas, batch 8), VGG-16 bf16 at full width with 4 classes,
   ``'align_pallas'`` and ``FUSE_CONV1``, seeded weights, the nets joined by
   ``share_trunk``: the host library's build, then ``evaluate_recall``
   batched, refined, and per image on 4, ``detect_all_batched`` fused
   (``fused=None``) and two-program, ``detect_all`` on 4,
   ``evaluate_detections``, ``calibrate_net_on_imdb`` on 8 and the int8
   net's batched recall, with every launch count set to 0 just before and
   read just after; each driver's wall time, ms per image and img/s, the
   host NMS's time per call. Checks the proposals, the detections, the
   recalls and APs, fused against two-program detection, every kernel's
   launches, the kernels on the first batches' inputs against their plain
   versions, and the drivers on the card against the CPU (VGG-16 at WIDTH
   0.125, float32, 4 images).

12. Phase 11: training at full VGG-16 width (``Config()``: bf16, ``'align'``,
   no ``FUSE_CONV1``, DROPOUT 0.5) on ``synthetic_hard_train`` (375x500 on a
   608x800 canvas at TRAIN.SCALES 600, b=2, 128 regions an image), with
   every launch count set to 0 at its start and read at its end: (a)
   ``train_az_net`` for 12 steps with mining every 4 steps over 8 images
   (the NMS kernel in each harvest; the first harvest's NMS inputs held
   against the plain version bit for bit), checking every step's losses and
   grad_norm finite, the parameters moved, the snapshot and the ``deploy/``
   copy; ms per step by CUDA events after 2 warm-up steps, img/s, the
   loop's wait on the prefetch thread, the card's busy share over steps
   6-8 and 10-12 (``torch.profiler``; the harvests are outside), peak
   memory, harvest ms per image; (b) a rerun to 14 steps in the same
   directory, which resumes at 12; (c) the chain: an inference net from the
   ``deploy/`` weights with phase 6's detect configuration
   (``'align_pallas'``, ``FUSE_CONV1``, 4 classes), ``propose_all`` over 8
   training images (NMS, ROI-align and conv1 kernels), then
   ``train_frcnn_net`` for 6 steps on those proposals; (d) ``REMAT_TRUNK``
   on against off (the first step's loss, peak memory), and 4 prefetch
   workers against the thread (ms per step, wait), the first two batches
   of 2 and 4 workers equal and no worker on CUDA or JAX; (e) one AZ and one
   Fast R-CNN step, smallnet float32, on the card against the CPU at the
   CPU tests' float32 bounds.

13. Phase 12: the command-line tools (``tools_torch/``) in-process through
   ``main(argv)``, on the card at full VGG-16 width with
   ``experiments/cfgs/az_vgg_w100_synthetic_hard.yml``, on the first 32
   images of ``synthetic_hard_train`` and the first 16 of
   ``synthetic_hard_test`` (registered under names of their own), every
   launch count set to 0 at its start and read at its end: (a)
   ``train_net --net az`` 24 steps with mining every 8 over 8 images, then
   a resume to 28; (b) ``propose_net --batched`` with ``'align_pallas'`` +
   ``FUSE_CONV1``; (c) ``train_net --net frcnn`` 12 steps on those
   proposals, then 4 with ``--init-trunk-from`` the AZ run, whose trunk
   stays byte-identical; (d) ``test_net --mode recall --batched``, with
   ``--int8`` and with ``--refine``; (e) ``test_net --mode detect
   --batched --share-trunk`` (the fused program); (f) ``demo``; (g)
   ``time_net --batch 2 --reps 3`` inside ``utils/profiling.trace``, whose
   trace must hold CUDA kernel events; (h) ``convert_caffe`` on a random
   ``.npz`` of VGG-16's full Caffe shapes, then ``test_net`` from that
   snapshot. Each leg's wall time and launches; NMS, ROI align, conv1,
   chain and strip must launch, IoU must not; the first launch of each
   kernel is held against its plain version.

14. Phase 13: the mesh paths (``aznet_tpu_torch.parallel``) at world size 1
   on NCCL, full VGG-16 width: ``make_mesh(1)`` starts the group; with
   every launch count and collective count set to 0 just before and read
   just after: ``make_sharded_propose`` on phase 2's two 375x500 images
   (bf16), with ``shard_regions=True``, ``make_latency_propose`` on image 0,
   the int8 net's sharded propose (phase 4's calibration),
   ``make_sharded_detect`` with the detect configuration on the 300
   proposals an image, one AZ train step on ``{data 1, model 1}`` (phase
   11's seeded state, 11d's batch) and ``train_net --mesh 1`` for 2 steps
   with a harvest. Each is held bit for bit against the plain path on the
   same inputs, each kernel's first launch against its plain version; the
   all-gathers and all-reduces must have run; then each call is timed
   beside its plain path in alternating rounds (one ``mesh`` JSON line).
   The group is destroyed at the end.

15. Phase 14: the last settings. (a) Phase 4's calibrated net rebuilt with
   ``INT8_CHAIN_FROM='conv1_2'`` from the same scales (only conv1_1 in bf16;
   conv1_2 through the chain entry with pool1 fused at C=64, conv2_1
   through the strip entry at C=64): ``make_propose_batch`` (b=2) and one
   ``im_propose`` with the conv counts set to 0 just before (chain 8,
   strip 16), every conv input against the plain version bit for bit (the
   C=64 shapes among them), the proposals checked as in phase 4, cosine >
   0.98 against the bf16 trunk; the trunk and its prefix timed against the
   trunk from conv2_2 in alternating rounds (medians of 3). Phase 3 times
   the kernel alone at those two C=64 layers. (b) The same net with
   ``INT8_BACKEND='xla'``: the propose path with the chain and strip
   counts at 0, 30 ``torch._int_mm`` calls a trunk call, the share of
   conv2_2's codes that differ from the chain kernel's, cosine > 0.999
   against the ``'pallas'`` trunk, both trunks timed in alternating rounds.
   (c) The float32 fused conv1 kernel (``csrc/conv1_fused_f32.cu``, 3xTF32
   on ``wgmma``): its SASS instruction mix from ``cuobjdump -sass`` (HGMMA
   on TF32 operands, or the phase fails); alone at b=2 608x800x64 against
   a float64 product of the same operands (at most twice the plain
   version's error, within 1e-5 of max|plain|), timed beside the plain
   version and cuDNN's float32 conv2d + relu + max_pool2d with TF32 off,
   its bound three TF32 products a multiply-add at the TF32 peak; then a float32 VGG-16 net at full width with
   ``FUSE_CONV1`` and ``'align_pallas'`` through the propose path (one f32
   conv1 launch a trunk call; the first launch's input held against
   float64), its trunk against the same net unfused (relative 1e-5). (d)
   ``'xla'`` at WIDTH 0.125 and the trunk from conv1_2 at full width on two
   64x64 images, on the card against the CPU at phase 4's bounds.

16. Phase 15: (a) the NMS kernel's large route (sort widths 16384 ..
   65536: the sort over chunks of keys, the scan reading the kept rows from
   global memory) at 1 x 8193, 1 x 16384 (tie-heavy, +-0, subnormal and
   invalid rows), 2 x 20000 and 1 x 32768 against the plain version, and
   at 1 x 65536 against the host library's greedy NMS (distinct scores), bit
   for bit, each timed (device time per pass, events, host) beside its
   bound; (b) ``tools_torch.bench`` in this process at ``full`` (batches 16
   and 32, with ``nms_mboxes_per_sec``), ``coco_deep`` and
   ``resnet50_1080p``; (c) ``tools_torch.bench_nms`` with its four tiers;
   (d) every other ``tools_torch/bench_*`` at its defaults
   (``bench_coco_eval --images 500``; ``bench_fused_detect`` on snapshots
   of seeded nets with ``az_vgg_w100_synthetic_hard.yml``, the fused and
   two-program mAPs within 1% of each other); (e) ``aznet_tpu_torch.entry``:
   ``entry()`` (shapes, finite, live proposals), ``dryrun_multichip(1)`` on
   NCCL and ``dryrun_multichip(2)`` over gloo ranks. Every launch count is
   set to 0 just before each tool and read just after; the first launch of
   each kernel a tool makes is held against its plain version.

The kernels on a path are reached through their table
(``aznet_tpu_torch/kernels.py``): ``kernels.recording`` copies what each
card entry is given and gives back, and ``kernels.held`` replays every copy
through the row's plain version on the card (bit for bit; conv1 within one
bf16 ulp). Every launch of the propose and detect paths is held (phases 2,
4, 6, 8, 9, 14a-c), every launch of the first batches in phase 10 and of the
first harvest in 11, and the first launch of each kernel, with every level
of the first search, in phases 12, 13 and 15. The launch counts are
``ops/cuda/__init__.py::launch_counts`` / ``set_launch_counts``. The
search-level kernel (``csrc/search_level.cu``, one launch a level of every
search on the card) runs in every phase that searches, its count set to 0
and read with the others' (phases 2, 4, 6, 8-13, 14a-c, 15); phase 5 also
holds it alone at R = 64 and 128 and times it beside the plain version and
its bound. The search's seed and selection kernels
(``csrc/search_select.cu``: three launches a search, counted together) are
counted and held beside it on the same paths, and phase 5 times them alone
at both benchmark configurations.

Prints the card's name and power limit, one JSON line of kernel records
(each with its bound, library yardstick and launches on the eval path, in
training, in the tools and on the mesh paths; the int8 conv's with its C=64
layer and its launches from conv1_2, the float32 conv1's, and the search
level's, whose yardstick is its plain version, not a library), and,
as the last line, ``{"ok": true, "device": {...}}``. Exits non-zero at the first failure and
when no CUDA device is present. Imports no JAX and nothing of ``aznet_tpu``.

    python3 chip_smoke.py --conv-times [ROOT]

times the int8 conv alone at phase 3's 10 layers and its two C=64 layers
(device and CUDA-event time, each beside its bound) with the package under
ROOT (default: this checkout), so that two
checkouts run in turn in one call compare two versions of the kernel.

    python3 chip_smoke.py --conv1-times [ROOT]

does the same for the fused conv1 kernels at phase 5's b=2 608x800x64 input,
the bf16 one and (where the checkout has it) the float32 one on the same
values in float32 (device time, TFLOP/s, share of the bf16 peak or, for
float32, of the 3xTF32 bound and of the f32 CUDA-core bound, CUDA-event
time). To compare with the parent commit, unpack it into ``build/parent``
(``git archive``) and run ``--conv1-times build/parent``, ``.``, ``.``,
``build/parent`` in one chip call.

    python3 chip_smoke.py --roi-times [ROOT]
    python3 chip_smoke.py --nms-times [ROOT]

do the same for the ROI-align kernel at phase 5's eight shapes and for the
NMS kernel at phase 1's three timed shapes (1 x 2048, 1 x 4096, 16 x 4096),
with the host's time per call beside the device and CUDA-event times, and
each NMS pass's device time (sort, mask, scan).

    python3 chip_smoke.py --mesh-phase

builds the kernels and runs phase 13 alone.

    python3 chip_smoke.py --tools-phase

builds the kernels and runs phase 15 alone.

    python3 chip_smoke.py --settings-phase

builds the kernels and runs phases 2 and 4 (the bf16 and int8 propose
paths, whose nets and calibration it needs) and phase 14.

    python3 chip_smoke.py --iou-times [ROOT]

does the same for the IoU kernel at phase 7's shapes (all but the
2,100,000-row one), then counts the SASS instructions per pair in the
kernel's storing loop (``cuobjdump -sass`` of the library built from ROOT;
the SASS goes to ``build/iou_sass_<ROOT>.txt``), then times 4096 x 4095
and 4096 x 4096 again in four sessions each, every session's output at a
new address.

    python3 chip_smoke.py --search-level-times [ROOT]

times one search level after the head, the kernel (``csrc/search_level.cu``)
and the plain version on the card, at the benchmark configurations' schedule
steps (device time and launches per call, CUDA-event and host time), each
first held bit for bit.

    python3 chip_smoke.py --search-select-times [ROOT]

does the same for the search's seed and its selection (``csrc/search_select.cu``
against ``seed_plain`` and ``select_plain``, the NMS kernel in both
selections) at both benchmark configurations' SEAR and image size.

    python3 chip_smoke.py --frozen-bn-times [ROOT]

records the 40 frozen BatchNorm epilogues (``csrc/frozen_bn.cu``) of one
bf16 ResNet-50 trunk call at the ``resnet50_1080p`` cell's shapes (4 frames on
1088x1920), holds them bit for bit against the plain version, and prints each
launch's device time inside the trunk call beside its bytes bound and its host
time alone, the plain chain's device time and launches, and the trunk call
with the kernel against the plain chain in alternating rounds, with each
one's peak memory; phase 5 runs the same in the full run, and phase 8 counts
the kernel's launches on the ResNet-50 bf16 and int8 paths (40 a trunk call)
and holds every one of them.
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
CONV1_F32_SOURCE = "aznet_tpu_torch/csrc/conv1_fused_f32.cu"
CONV1_REPLACES = "aznet_tpu/ops/pallas/conv1_kernel.py:132"
IOU_SOURCE = "aznet_tpu_torch/csrc/iou.cu"
IOU_REPLACES = "aznet_tpu/ops/pallas/iou_kernel.py:43"
SEARCH_LEVEL_SOURCE = "aznet_tpu_torch/csrc/search_level.cu"
SEARCH_LEVEL_PLAIN = "aznet_tpu_torch/search/propose.py::level_plain"
SEARCH_SELECT_SOURCE = "aznet_tpu_torch/csrc/search_select.cu"
SEARCH_SELECT_PLAIN = ("aznet_tpu_torch/search/propose.py::seed_plain",
                       "aznet_tpu_torch/search/propose.py::select_plain")
FROZEN_BN_SOURCE = "aznet_tpu_torch/csrc/frozen_bn.cu"
FROZEN_BN_PLAIN = "aznet_tpu_torch/ops/frozen_bn.py::frozen_bn_relu_reference"
ROI_LEVELS_PLAIN = "aznet_tpu_torch/ops/roi_pool.py::roi_align_levels_reference"
# (R, next_cap) of the benchmark configurations' search levels.
SEARCH_LEVEL_STEPS = ((8, 32), (32, 64), (32, 128), (64, 64), (128, 128))
BATCH = 2
RAW_HW = (375, 500)
CANVAS = (608, 800)
RESNET_RAW_HW = (1080, 1920)  # resnet50_1080p: raw 1080p frames on a 1088x1920 canvas
RESNET_CANVAS = (1088, 1920)
DETECT_ROIS = 300
# One H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W): device
# memory bytes/s and operations/s per type; "f32" is the rate outside the
# tensor cores, where the NMS and ROI-align kernels do their arithmetic;
# "tf32" the tensor cores' rate on TF32 operands, which the float32 conv1
# kernel takes three times over (3xTF32).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12}
IOU_OPS = 15  # f32 operations per IoU of a box pair (NMS mask pass, IoU kernel)


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


def device_times(fn, names, iters=20, attempts=3):
    """{name: mean device time in microseconds per call of ``fn`` of the
    kernels whose name holds ``name``}, under ``torch.profiler``; None when
    the profiler saw none of them in ``attempts`` sessions (one session of
    many in a process has come back without the card's events). Unlike
    :func:`cuda_ms` over back-to-back calls, it leaves out the host's launch
    overhead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        out = {n: sum(e.self_device_time_total for e in events if n in e.key) / iters
               for n in names}
        if any(out.values()):
            return out
    return None


def device_us(fn, name, iters=20, attempts=3):
    """Mean device time in microseconds per call of ``fn`` of the kernels
    whose name holds ``name`` (:func:`device_times`); None when not seen."""
    out = device_times(fn, [name], iters, attempts)
    return out and out[name]


def launch_us(fn, name, iters=20):
    """(mean device time in microseconds of one launch of the kernel whose
    name holds ``name``, launched once a call of ``fn``, over the launches
    ``torch.profiler`` saw; their count): unlike :func:`device_us`, a
    session that loses some of the card's events still gives the mean."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if name in e.key]
    n = sum(e.count for e in events)
    return (sum(e.self_device_time_total for e in events) / n if n else None), n


def host_us(fn, iters=50):
    """Host time in microseconds per call of ``fn``: back-to-back calls with
    no synchronisation inside, so the clock reads what the host spends to
    enqueue each call (at these counts the card's launch queue never fills
    and blocks the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def nms_inputs(seed, bsz, n, extent, tie_rows, dev, presorted=False):
    """Boxes uniform in [0, extent] plus wh in [5, 300]; uniform scores, except
    ``tie_rows`` streams with 8-level ties, +-0, subnormals and invalid rows.
    ``presorted``: each stream's rows in score-descending order."""
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
    boxes = np.concatenate([xy, xy + wh], -1)
    if presorted:
        order = np.argsort(-scores, axis=1, kind="stable")
        boxes = np.take_along_axis(boxes, order[..., None], 1)
        scores = np.take_along_axis(scores, order, 1)
    return [torch.from_numpy(a).to(dev) for a in (boxes, scores, valid)]


NMS_CASES = [  # name, seed, B, N, extent, tie streams, IoU, timed
    ("path_1x2048", 0, 1, 2048, 1000.0, 0, 0.7, True),
    ("cell_16x4096", 3, 16, 4096, 2000.0, 0, 0.5, True),
    ("ties_4x2048", 5, 4, 2048, 1000.0, 4, 0.7, False),
    ("ties_2x1000", 6, 2, 1000, 500.0, 2, 0.5, False),
    # The input of tools/bench_nms_variants.py's kernel-only launch of
    # _nms_kernel_nosub: already score-sorted (the sort is the identity,
    # so the keep mask is in sorted order too).
    ("presorted_16x4096", 3, 16, 4096, 2000.0, 0, 0.5, True),
    ("path_1x4096", 4, 1, 4096, 1900.0, 0, 0.7, True),  # ResNet-50's CAND_BUF
]
NMS_PASSES = ("sort_kernel", "mask_kernel", "scan_kernel")  # the kernel's three launches


def nms_case_inputs(name, dev):
    """Boxes, scores and valid flags of the :data:`NMS_CASES` entry ``name``,
    with its IoU threshold."""
    _, seed, bsz, n, extent, ties, iou, _ = next(c for c in NMS_CASES if c[0] == name)
    return nms_inputs(seed, bsz, n, extent, ties, dev, presorted=name.startswith("presorted")), iou


def nms_kernel_times(boxes, scores, iou, valid):
    """The NMS dispatch on the card, timed: {"ms": CUDA events per call over
    back-to-back calls, "host_us": the host's time per call, "device_us":
    the three passes' device time per call, "passes": {pass: device us}}."""
    from aznet_tpu_torch.ops import nms as tnms

    run = lambda: tnms.nms_mask_batched(boxes, scores, iou, valid)
    passes = device_times(run, NMS_PASSES)
    check(passes is not None, "the profiler saw no NMS pass")
    return {"ms": cuda_ms(run, 20, 3), "host_us": host_us(run), "passes": passes,
            "device_us": sum(passes.values())}


def nms_times_line(t):
    return (f"device {t['device_us']:.2f} us (" + ", ".join(
        f"{k.split('_')[0]} {v:.2f}" for k, v in t["passes"].items()) + f"), events "
        f"{t['ms']:.4f} ms, host {t['host_us']:.2f} us per call, events - device "
        f"{t['ms'] * 1e3 - t['device_us']:.2f} us")


def phase1_nms(dev):
    """Kernel vs plain on the card. Returns (max_abs_err, timings)."""
    import torch

    from aznet_tpu_torch.ops import nms as tnms

    err = 0.0
    times = {}
    for name, _, bsz, n, _, _, _, timed in NMS_CASES:
        (boxes, scores, valid), iou = nms_case_inputs(name, dev)
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
            t = nms_kernel_times(boxes, scores, iou, valid)
            t["plain_ms"] = cuda_ms(lambda: tnms.nms_mask_reference(boxes, scores, iou, valid),
                                    3, 1)
            times[name] = t
            b_ms, b_by = nms_bound(bsz, n)
            print(f"phase1 {name}: kernel {nms_times_line(t)}; plain {t['plain_ms']:.4f} ms, "
                  f"kernel {bsz * n / t['ms'] / 1e3:.2f} Mboxes/s, bound {b_ms * 1e3:.3f} us "
                  f"({b_by})", flush=True)
    return err, times


def nms_times(dev, root):
    """``--nms-times [ROOT]``: the NMS kernel at phase 1's three timed main
    shapes (1 x 2048 and 1 x 4096 at IoU 0.7, 16 x 4096 at 0.5), each pass's
    device time, CUDA-event time and host time, with the package found under
    ROOT (default: this checkout)."""
    for name in ("path_1x2048", "path_1x4096", "cell_16x4096"):
        (boxes, scores, valid), iou = nms_case_inputs(name, dev)
        print(f"nms-times {root} {name}: {nms_times_line(nms_kernel_times(boxes, scores, iou, valid))}",
              flush=True)


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



def hold(tag, records, what="the path's inputs"):
    """Every launch in ``records`` (``kernels.recording``) against its plain
    version on the same inputs (``kernels.held``): one line, and a check
    that each kernel keeps its row's rule (bit for bit; conv1 within one
    bf16 ulp). Returns {kernel: max_abs_err}."""
    from aznet_tpu_torch import kernels

    seen = kernels.held(records)
    print(f"{tag} kernels on {what}: " + ("; ".join(
        f"{k} ({v['n']} launches held, shapes {v['shapes']}) max_abs_err {v['err']}"
        + (f", {v['differ']:.4%} of elements differ" if v["differ"] else "")
        for k, v in seen.items()) or "no kernel launched"), flush=True)
    bad = sorted(k for k, v in seen.items() if not v["ok"])
    check(not bad, f"{tag}: {bad} disagree with their plain versions on {what}")
    return {k: v["err"] for k, v in seen.items()}


def phase2_propose(dev, net, tag="phase2", counters=(), raw_hw=RAW_HW, canvas=CANVAS,
                   records=None, recorders=()):
    """The propose path of ``net`` on two raw ``raw_hw`` images on a
    ``canvas``, every kernel launch recorded into ``records`` (a new list if
    None) and held against its plain version. The launch counts of NMS, the
    search's kernels and ``counters`` are set to 0 just before the path and
    read just after; ``recorders`` are context managers that wrap other
    calls of the path while it runs. Returns {"launches": {name: count},
    "err": {kernel: max_abs_err}, "ips", "blobs": the preprocessed blobs of
    the two images}."""
    import torch

    from aznet_tpu_torch import api, kernels
    from aznet_tpu_torch.ops.cuda import launch_counts, set_launch_counts

    cfg = net.cfg
    rng = np.random.RandomState(0)
    ims_np = rng.randint(0, 256, (BATCH,) + raw_hw + (3,)).astype(np.uint8)
    images = torch.from_numpy(ims_np).to(dev)
    fn = api.make_propose_batch(net.model, cfg, canvas)

    names = ("nms", "search_level", "search_select", *counters)
    with contextlib.ExitStack() as stack:
        records = stack.enter_context(kernels.recording(records=records))
        for rec in recorders:
            stack.enter_context(rec)
        set_launch_counts(dict.fromkeys(names, 0))
        boxes, scores, valid = fn(images)
        dets = api.im_propose(net, ims_np[0])
        torch.cuda.synchronize()
        now = launch_counts()
        counts = {k: now[k] for k in names}
    print(f"{tag} main path: " + ", ".join(f"{k} launches {v}" for k, v in counts.items()),
          flush=True)
    check(counts["nms"] >= BATCH + 1,
          f"NMS kernel launched {counts['nms']} times, expected >= {BATCH + 1}")
    check(counts["search_level"] >= BATCH + 1, f"search-level kernel launched "
          f"{counts['search_level']} times in {BATCH + 1} searches")
    check(counts["search_select"] >= 3 * (BATCH + 1) and counts["search_select"] % 3 == 0,
          f"search seed and selection kernels launched {counts['search_select']} times in "
          f"{BATCH + 1} or more searches")

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

    errs = hold(tag, records)
    check("search_level" in errs, f"{tag}: no search level recorded")

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
    return {"launches": counts, "err": errs, "ips": ips, "blobs": blobs}


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
        if hasattr(trunk, "int8_prefix") and trunk.int8_mode:  # VGG-16's int8 split
            codes = trunk.int8_prefix(blobs)
            split = (f" (bf16 prefix + quantize {cuda_ms(lambda: trunk.int8_prefix(blobs), 5, 2):.4f}"
                     f" ms, int8 layers {cuda_ms(lambda: trunk.int8_body(codes), 5, 2):.4f} ms)")
    print(f"{tag} breakdown: trunk {trunk_ms:.4f} ms per batch of {blobs.shape[0]}{split}, "
          f"az_search {search_ms:.4f} ms per image, roi_forward(R=64) {head_ms:.4f} ms "
          f"(feat {tuple(feat.shape)} {feat.dtype})", flush=True)


def phase2_reference(dev):
    """The port on the card against the port on the CPU: smallnet, the
    small f32 config of :func:`card_vs_cpu`."""
    from aznet_tpu_torch.config import Config, cfg_from_dict

    card_vs_cpu("phase2", cfg_from_dict(Config(), {"MODEL": {"BACKBONE": "smallnet"}}), dev)


def precision_probe(dev):
    """Which TF32 settings the card's float32 convolution (cuDNN) and matmul
    (cuBLAS) honour: for PyTorch's defaults, the legacy flags
    (``cudnn.allow_tf32``, ``matmul.allow_tf32``) and the newer
    ``fp32_precision`` settings (``cudnn.conv``, ``cuda.matmul``), the error
    of each against float64 on the CPU (TF32 keeps 10 mantissa bits: about
    1e-4..1e-3 relative here; float32 about 1e-7), and what reading the
    other API gives after setting one (a value, or the error it raises).
    Then the port's scope (``utils/precision.py``) under a caller's TF32, set
    through either API: true float32, and the caller's settings back, each
    as it read before. The process's flags are
    PyTorch's defaults again at the end."""
    import torch
    import torch.nn.functional as F

    from aznet_tpu_torch.utils.precision import float32_precision

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(2, 64, 40, 40).astype(np.float32))
    w = torch.from_numpy((rng.randn(64, 64, 3, 3) * 0.05).astype(np.float32))
    a = torch.from_numpy(rng.randn(256, 1024).astype(np.float32))
    bm = torch.from_numpy(rng.randn(1024, 256).astype(np.float32))
    conv_ref = F.conv2d(x.double(), w.double(), padding=1)
    mm_ref = a.double() @ bm.double()
    xd, wd, ad, bd = (t.to(dev) for t in (x, w, a, bm))

    def rel(got, want):
        return float((got.double().cpu() - want).abs().max() / want.abs().max())

    def errs():
        out = []
        for fn, ref in ((lambda: F.conv2d(xd, wd, padding=1), conv_ref), (lambda: ad @ bd, mm_ref)):
            try:
                out.append(f"{rel(fn(), ref):.2e}")
            except RuntimeError as e:
                out.append(f"raises ({str(e)[:60]}...)")
        return out

    def reads():
        out = []
        for name, get in (("cudnn.allow_tf32", lambda: cudnn.allow_tf32),
                          ("cudnn.conv.fp32_precision", lambda: cudnn.conv.fp32_precision),
                          ("matmul.allow_tf32", lambda: matmul.allow_tf32),
                          ("matmul.fp32_precision", lambda: matmul.fp32_precision)):
            try:
                out.append(f"{name}={get()}")
            except (RuntimeError, AttributeError) as e:
                out.append(f"{name} raises {type(e).__name__}")
        return ", ".join(out)

    def defaults():  # the legacy setters leave both APIs consistent
        cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("highest")

    def new_api(value):
        cudnn.conv.fp32_precision = value
        matmul.fp32_precision = value

    settings = (("PyTorch's defaults", lambda: None),
                ("legacy allow_tf32 True", lambda: (setattr(cudnn, "allow_tf32", True),
                                                    setattr(matmul, "allow_tf32", True))),
                ("legacy allow_tf32 False", lambda: (setattr(cudnn, "allow_tf32", False),
                                                     setattr(matmul, "allow_tf32", False))),
                ("new fp32_precision 'tf32'", lambda: new_api("tf32")),
                ("new fp32_precision 'ieee'", lambda: new_api("ieee")))
    for name, apply in settings:
        defaults()
        try:
            apply()
            line = f"conv, matmul rel err {errs()}; then {reads()}"
        except (RuntimeError, AttributeError) as e:
            line = f"setting raises {type(e).__name__}: {str(e)[:80]}"
        print(f"phase2 precision probe, {name}: {line}", flush=True)
    for name, apply in settings[1:4:2]:  # a caller's TF32 through either API
        defaults()
        apply()
        before = reads()
        with float32_precision():
            conv_err = rel(F.conv2d(xd, wd, padding=1), conv_ref)
            mm_err = rel(ad @ bd, mm_ref)
        restored = reads() == before
        print(f"phase2 precision probe, caller's {name}, inside the port's scope: conv, matmul "
              f"rel err {conv_err:.2e}, {mm_err:.2e}; settings restored {restored}", flush=True)
        check(conv_err < 1e-5 and mm_err < 1e-5 and restored,
              "the port's float32 scope did not give float32 on the card")
    defaults()


def bf16_reduction_probe(dev):
    """fc6 at full width on the card (VGG-16's detect head: R=300 x K=25,088
    x N=4,096, bf16 operands, ``F.linear`` as ``FCStack``) with
    ``allow_bf16_reduced_precision_reduction`` True (PyTorch's default) and
    False, each against an f32 product of the same bf16 operands (TF32 off),
    beside the bf16 rounding of that product, and the time of each."""
    import torch
    import torch.nn.functional as F

    from aznet_tpu_torch.utils.precision import float32_precision

    matmul = torch.backends.cuda.matmul
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    x = (torch.relu(torch.randn((DETECT_ROIS, 25088), generator=g, device=dev)) * 4
         ).to(torch.bfloat16)
    w = (torch.randn((4096, 25088), generator=g, device=dev) * 0.005).to(torch.bfloat16)
    b = (torch.randn((4096,), generator=g, device=dev) * 0.1).to(torch.bfloat16)
    with float32_precision():
        ref = x.float() @ w.float().t() + b.float()
    scale = ref.abs().max()
    prev = matmul.allow_bf16_reduced_precision_reduction
    outs, line = {}, []
    try:
        for flag in (True, False):
            matmul.allow_bf16_reduced_precision_reduction = flag
            run = lambda: F.linear(x, w, b)
            outs[flag] = run()
            err = float((outs[flag].float() - ref).abs().max() / scale)
            line.append(f"{flag}: max err {err:.3e} of max |y|, {cuda_ms(run, 20, 3):.4f} ms")
    finally:
        matmul.allow_bf16_reduced_precision_reduction = prev
    rounding = float((ref.to(torch.bfloat16).float() - ref).abs().max() / scale)
    apart = float((outs[True].float() - outs[False].float()).abs().max() / scale)
    print(f"phase2 bf16 fc6 {DETECT_ROIS}x25088x4096, allow_bf16_reduced_precision_reduction "
          f"{'; '.join(line)}; bf16 rounding of the f32 product {rounding:.3e}; True vs False "
          f"{apart:.3e} of max |y| (max |y| {float(scale):.4g})", flush=True)


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


def c64_int8_layers():
    """conv1_2 and conv2_1 of the int8 trunk from conv1_2 (``INT8_CHAIN_FROM
    'conv1_2'``), at b=2 on the canvas: (name, H, W, C, Co, pool, exit)."""
    h, w = CANVAS
    return [("conv1_2", h, w, 64, 64, True, False),
            ("conv2_1", h // 2, w // 2, 64, 128, False, False)]


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


def im2col_gemm(x, layer):
    """The layer's GEMM core as one ``torch._int_mm`` call (the yardstick;
    the port never calls it): the im2col matrix ``[B*H*W, 9*C]`` and the
    weights ``[9*C, Co]`` (column-major), both built here, outside any timed
    region. Returns the call."""
    import torch
    import torch.nn.functional as F

    from aznet_tpu_torch.ops.conv_int8 import unpack_kernel_layout

    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.stack([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                       dim=3).reshape(b * h * w, 9 * c)
    co = layer.s_w.shape[0]
    wmat = unpack_kernel_layout(layer.w_k, c, co).permute(2, 0, 1).reshape(co, 9 * c).contiguous()
    return lambda: torch._int_mm(cols, wmat.t())


def phase3_conv(dev):
    """The int8 conv kernel alone at the main path's shapes and at the two
    C=64 layers of the trunk from conv1_2. Returns {"err": {entry:
    max_abs_err}, "ms"/"plain_ms"/"library_ms": {entry: summed over the
    main-path layers that entry runs}, "c64": {entry: that entry's C=64
    layer's record}}."""
    import torch

    from aznet_tpu_torch.ops import conv_int8 as tconv
    from aznet_tpu_torch.ops.cuda import conv_int8_kernel as ck

    s_x = 0.0419
    entries = ("chain", "strip")
    err = {e: 0.0 for e in entries}
    ms, plain_ms, library_ms, dev_us = ({e: 0.0 for e in entries} for _ in range(4))
    c64 = {}
    cases = [(*layer, True) for layer in main_path_int8_layers()]
    h0, w0 = cases[0][1:3]  # conv2_2's map: the strip entry there, and at C=64
    cases += [("conv2_2_nopool", h0, w0, 128, 128, False, False, False),
              ("c64_input", h0, w0, 64, 128, False, False, False)]
    cases += [(f"{name}_c64", *rest, True) for name, *rest in c64_int8_layers()]
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
        tile = ck.tile_config(x, co)
        line = (f"phase3 {name} {entry} {BATCH}x{h}x{w}x{c}->{co}"
                f"{' pool' if pool else ''}{' bf16 exit' if last else ''}: "
                f"max_abs_err {diff}, nonzero {nz:.3f}, max |out| {want.float().abs().max().item()}"
                f"; tile {tile['rows']}x{tile['cols']}x{tile['co']}, grid {tile['grid']}")
        check(diff == 0.0, f"int8 conv kernel disagrees with the plain version at {name}")
        check(0.01 < nz, f"{name}: degenerate output")
        if timed:
            k_ms, p_ms = cuda_ms(run, 20, 3), cuda_ms(plain, 3, 1)
            k_us = device_us(run, "conv3x3_int8")
            check(k_us is not None, f"{name}: the profiler saw no conv kernel")
            gemm = im2col_gemm(x, layer)
            l_ms, l_us = cuda_ms(gemm, 20, 3), device_us(gemm, "")
            b_ms, b_by = int8_layer_bound(h, w, c, co, pool, last)
            if name.endswith("_c64"):
                c64[entry] = {"layer": name[:-4], "shape": f"{BATCH}x{h}x{w}x{c}->{co}",
                              "max_abs_err": diff, "ms": k_ms, "device_us": k_us,
                              "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                              "bound_by": b_by}
            else:
                ms[entry] += k_ms
                plain_ms[entry] += p_ms
                library_ms[entry] += l_ms
                dev_us[entry] += k_us
            ops = 2.0 * BATCH * h * w * 9 * c * co
            line += (f"; kernel {k_ms:.4f} ms by events, device {k_us:.2f} us "
                     f"({ops / k_us / 1e6:.1f} TOP/s), plain {p_ms:.4f} ms; int8 GEMM core, "
                     f"no im2col, no epilogue (torch._int_mm {BATCH * h * w}x{9 * c}x{co}): "
                     f"{l_ms:.4f} ms by events, device {l_us:.2f} us "
                     f"({ops / l_us / 1e6:.1f} TOP/s); bound {b_ms * 1e3:.2f} us ({b_by})")
        print(line, flush=True)
    # The one main-path shape where the host picks 2-row tiles: conv5 at b=1
    # (im_propose's trunk call); both tiles timed, each held against plain.
    name, h, w, c, co, _, _ = main_path_int8_layers()[-2]
    x, layer = conv_case(200, h, w, c, co, dev)
    x = x[:1].contiguous()
    chosen = ck.tile_config(x, co)["rows"]
    real_rows, us = ck.tile_rows, {}
    try:
        for rows in (chosen, 6 - chosen):
            ck.tile_rows = lambda *args, rows=rows: rows
            run = lambda: tconv.conv3x3_int8(x, s_x, layer, 0.4, pool=False)
            check(torch.equal(run(), tconv.conv3x3_int8_reference(x, s_x, layer, 0.4)),
                  f"int8 conv kernel with {rows}-row tiles disagrees at {name}, b=1")
            us[rows] = device_us(run, "conv3x3_int8")
    finally:
        ck.tile_rows = real_rows
    print(f"phase3 tile choice at {name} b=1 (1x{h}x{w}x{c}->{co}): chosen {chosen} rows "
          f"{us[chosen]:.2f} us, {6 - chosen} rows {us[6 - chosen]:.2f} us (device)", flush=True)
    for entry in entries:
        print(f"phase3 {entry} per trunk call (b={BATCH}): kernel {ms[entry]:.4f} ms by events, "
              f"device {dev_us[entry]:.2f} us; plain {plain_ms[entry]:.4f} ms; int8 GEMM core, "
              f"no im2col, no epilogue (torch._int_mm) {library_ms[entry]:.4f} ms; bound "
              f"{int8_conv_bound(entry)[0]:.4f} ms (operations)", flush=True)
    print(f"phase3 the 10 int8 layers per trunk call (b={BATCH}): device "
          f"{sum(dev_us.values()):.2f} us, events {sum(ms.values()):.4f} ms", flush=True)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "c64": c64}


def conv_times(dev, root):
    """``--conv-times [ROOT]``: the int8 conv alone at the main path's 10
    layers (phase 3's inputs), device time and CUDA-event time, with the
    package found under ROOT (default: this checkout). Two checkouts run in
    turn inside one chip call compare two versions of the kernel on one card."""
    from aznet_tpu_torch.ops import conv_int8 as tconv

    total_us = total_ms = 0.0
    layers = main_path_int8_layers()
    for k, (name, h, w, c, co, pool, last) in enumerate(layers + c64_int8_layers()):
        x, layer = conv_case(100 + k, h, w, c, co, dev)
        s_out = None if last else 0.3717 + 0.01 * k
        run = lambda: tconv.conv3x3_int8(x, 0.0419, layer, s_out, pool=pool)
        k_us, k_ms = device_us(run, "conv3x3_int8"), cuda_ms(run, 20, 3)
        check(k_us is not None, f"{name}: the profiler saw no conv kernel")
        b_ms, b_by = int8_layer_bound(h, w, c, co, pool, last)
        print(f"conv-times {root} {name} {BATCH}x{h}x{w}x{c}->{co}: device {k_us:.2f} us, "
              f"events {k_ms:.4f} ms; bound {b_ms * 1e3:.2f} us ({b_by})", flush=True)
        if k < len(layers):
            total_us, total_ms = total_us + k_us, total_ms + k_ms
    print(f"conv-times {root}: 10 layers device {total_us:.2f} us, events {total_ms:.4f} ms",
          flush=True)


def calibrated_int8(tag, net, dev):
    """The bf16 ``net`` calibrated on two random canvases (``RandomState(7)``
    minus the pixel means) and rebuilt int8 from its float32 parameters, with
    ``INT8_ROI``: ``bench.py:145-180``'s settings."""
    import dataclasses

    import torch

    from aznet_tpu_torch.ops.quant import (calibrate_head_int8, calibrate_trunk_int8,
                                           with_int8_scales)

    cfg = net.cfg
    t0 = time.perf_counter()
    calib = np.random.RandomState(7).randint(0, 256, (2,) + CANVAS + (3,)).astype(np.float32)
    calib -= np.asarray(cfg.PIXEL_MEANS, np.float32)
    scales = calibrate_trunk_int8(net, calib, batch_size=2)
    head_scales = calibrate_head_int8(net, calib, scales)
    torch.cuda.synchronize()
    print(f"{tag} calibration: {time.perf_counter() - t0:.2f} s; trunk scales "
          f"{[round(s, 6) for s in scales]}, head scales {[round(s, 6) for s in head_scales]}",
          flush=True)
    cfg8 = with_int8_scales(cfg, scales, head_scales)
    cfg8 = dataclasses.replace(cfg8, MODEL=dataclasses.replace(cfg8.MODEL, INT8_ROI=True))
    return build_net(tag, cfg8, dev, state_dict=net.params)



def phase4_int8(dev, net, blobs, bf16_ips):
    """Calibrate the bf16 ``net``, rebuild it int8 from its float32
    parameters, drive the int8 propose path. Returns its launches, the
    kernels' errors on the path's inputs, and img/s."""
    import torch

    net8 = calibrated_int8("phase4", net, dev)
    p = phase2_propose(dev, net8, "phase4", counters=("chain", "strip"))
    counts = p["launches"]
    trunk_calls = 2  # make_propose_batch on the batch, then im_propose
    check(counts["chain"] + counts["strip"] >= 10 * trunk_calls,
          f"int8 conv kernel launched {counts} times in {trunk_calls} trunk calls")
    check(counts["chain"] > 0 and counts["strip"] > 0, f"an int8 conv entry never ran: {counts}")

    with torch.inference_mode():
        f16 = net.model.features(blobs).float()
        f8 = net8.model.features(blobs).float()
    cos = cosine(f16, f8)
    print(f"phase4 int8 vs bf16 trunk features: cosine {cos:.6f}", flush=True)
    check(cos > 0.98, f"int8 trunk features drift from the bf16 trunk: cosine {cos}")
    print(f"phase4 img/s at b={BATCH}: int8 {p['ips']:.2f} vs bf16 {bf16_ips:.2f} (same call)",
          flush=True)
    return {**p, "net": net8, "bf16_feat": f16, "blobs": blobs}


def cosine(a, b):
    return (a * b).sum().item() / max(a.norm().item() * b.norm().item(), 1e-9)


def phase4_reference(dev, backend="pallas"):
    """The int8 port on the card against the port on the CPU: VGG-16 at WIDTH
    0.125 (the strip entry under ``'pallas'``; ``_int_mm`` under ``'xla'``),
    fixed scales, seeded weights (:func:`int8_card_vs_cpu`)."""
    import torch

    from aznet_tpu_torch.config import Config, cfg_from_dict
    from aznet_tpu_torch import api
    from aznet_tpu_torch.ops.quant import with_int8_scales

    cfg = cfg_from_dict(Config(), {"MODEL": {"WIDTH": 0.125, "FC_DIM": 64,
                                             "INT8_BACKEND": backend}})
    cfg = with_int8_scales(cfg, [2.0, 1.5, 1.2, 0.8, 0.6, 0.4, 0.3, 0.2, 0.15, 0.1,
                                 0.08, 0.06, 0.05])
    cpu_net = api.build_az_net(cfg, device="cpu")
    gpu_net = api.build_az_net(cfg, state_dict=cpu_net.params, device=dev)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.uniform(-120, 120, (2, 96, 128, 3)).astype(np.float32))
    tag = "phase4 reference" if backend == "pallas" else f"phase14d {backend}"
    int8_card_vs_cpu(f"{tag} (int8 VGG-16 WIDTH 0.125, INT8_BACKEND {backend!r}, card vs CPU)",
                     cpu_net.model.trunk, gpu_net.model.trunk, x, dev,
                     {"chain": 0, "strip": 10 if backend == "pallas" else 0})


def int8_card_vs_cpu(tag, cpu_trunk, gpu_trunk, x, dev, launches):
    """An int8 VGG-16 trunk on the card against the same trunk on the CPU. The
    int8 codes that leave the bf16 prefix may differ where the two devices'
    float convs round a value at a quantization boundary (<= 1 code on <=
    0.1%); from the same codes the int8 layers agree bit for bit, with
    ``launches`` of each conv entry; the whole trunk within 2% of its
    largest value."""
    import torch

    from aznet_tpu_torch.ops.cuda import launch_counts

    with torch.inference_mode():
        codes_cpu = cpu_trunk.int8_prefix(x)
        codes_gpu = gpu_trunk.int8_prefix(x.to(dev))
        before = launch_counts()
        got = gpu_trunk.int8_body(codes_gpu).cpu()
        launched = {e: launch_counts()[e] - before[e] for e in launches}
        want = cpu_trunk.int8_body(codes_gpu.cpu())
        full_gpu = gpu_trunk(x.to(dev)).float().cpu()
        full_cpu = cpu_trunk(x).float()
    d = (codes_gpu.cpu().int() - codes_cpu.int()).abs()
    frac = (d > 0).float().mean().item()
    body_err = (got.float() - want.float()).abs().max().item()
    rel = ((full_gpu - full_cpu).abs().max() / full_cpu.abs().max()).item()
    print(f"{tag}: prefix codes differ on {frac:.2e} (max {d.max().item()}), trunk body from "
          f"the same codes max_abs_err {body_err} ({launched}), whole trunk max rel err "
          f"{rel:.3g}", flush=True)
    check(d.max().item() <= 1 and frac <= 1e-3, f"{tag}: card and CPU int8 prefix codes disagree")
    check(body_err == 0.0 and launched == launches,
          f"{tag}: card and CPU int8 trunk bodies disagree (or launched {launched}, not "
          f"{launches})")
    check(rel <= 2e-2, f"{tag}: card and CPU int8 trunks disagree")


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


def int8_layer_bound(h, w, c, co, pool, last):
    """One int8 conv layer at b=2: int8 input, int8 weights, scales and bias
    read once, the output written once (bf16 at the exit)."""
    out_px = BATCH * h * w // (4 if pool else 1)
    nbytes = BATCH * h * w * c + 9 * c * co + 8 * co + out_px * co * (2 if last else 1)
    return bound(nbytes, 2.0 * BATCH * h * w * 9 * c * co, "int8")


def int8_conv_bound(entry):
    """Summed over the main-path layers the entry runs (b=2)."""
    ms = sum(int8_layer_bound(h, w, c, co, pool, last)[0]
             for _, h, w, c, co, pool, last in main_path_int8_layers()
             if pool == (entry == "chain"))
    return ms, "operations"


def roi_bound(feat, rois, w_first, scale=1 / 16.0):
    """The feature cells the rois' taps touch, the rois and the output, each
    moved once; two f32 operations per channel for every tap of the two
    contractions that this run's rois have (zero-weight slots excluded); a
    pool of 7 at ``scale``."""
    import torch

    from aznet_tpu_torch.ops import roi_pool as troi

    h, w, c = feat.shape
    scaled = rois.float() * scale
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


def detect_rois(n, seed, dev, canvas=CANVAS):
    """``n`` boxes on the ``canvas``: corners uniform, sides log-uniform in
    [16, 600] pixels, clipped to the canvas (the search's scaled boxes)."""
    import torch

    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, (canvas[1] - 16, canvas[0] - 16), (n, 2))
    wh = np.exp(rng.uniform(np.log(16), np.log(600), (n, 2)))
    xy2 = np.minimum(xy + wh, (canvas[1] - 1, canvas[0] - 1))
    return torch.from_numpy(np.concatenate([xy, xy2], 1).astype(np.float32)).to(dev)


def time_roi(feat, rois, tag):
    """The ROI-align kernel on ``feat``/``rois`` (order by the reference's
    rule) bit for bit against its plain version, timed by events and on the
    device beside the plain version and the einsum ``'align'``. Returns
    {"err", "ms", "device_us", "plain_ms", "library_ms", "bound"}."""
    import torch

    from aznet_tpu_torch.ops import roi_pool as troi
    from aznet_tpu_torch.ops.cuda import roi_align_kernel

    h, w, c = feat.shape
    wf = troi.fused_w_first(h, w, c, feat.element_size())
    run = lambda: troi.roi_align_fused(feat, rois, 1 / 16.0, 7)
    got, want = run(), troi.roi_align_fused_reference(feat, rois, 1 / 16.0, 7, wf)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    t = roi_kernel_times(feat, rois)
    p_ms = cuda_ms(lambda: troi.roi_align_fused_reference(feat, rois, 1 / 16.0, 7, wf), 5, 1)
    l_ms = cuda_ms(lambda: troi.roi_align(feat, rois, 1 / 16.0, 7), 20, 2)
    b_ms, b_by = roi_bound(feat, rois, wf)
    name = roi_case_name(feat, rois)
    print(f"phase5 roi_align {tag} {name}: max_abs_err {err}, max |out| "
          f"{want.float().abs().max().item()}; kernel {roi_times_line(t)}; plain {p_ms:.4f} ms, "
          f"library (einsum 'align') {l_ms:.4f} ms, bound {b_ms * 1e3:.3f} us ({b_by})",
          flush=True)
    check(err == 0.0, f"ROI-align kernel disagrees with the plain version at {name}")
    return {"err": err, "ms": t["ms"], "device_us": t["device_us"], "plain_ms": p_ms,
            "library_ms": l_ms, "bound": (b_ms, b_by), "w_first": wf}


def roi_case_name(feat, rois):
    from aznet_tpu_torch.ops import roi_pool as troi

    h, w, c = feat.shape
    wf = troi.fused_w_first(h, w, c, feat.element_size())
    return f"{str(feat.dtype)[6:]} {h}x{w}x{c} R={rois.shape[0]} {'W' if wf else 'H'}-first"


def roi_kernel_times(feat, rois):
    """The ``'align_pallas'`` dispatch (``roi_align_fused``) on the card,
    timed: {"ms": CUDA events per call over back-to-back calls, "device_us",
    "host_us": the host's time per call}."""
    from aznet_tpu_torch.ops import roi_pool as troi

    run = lambda: troi.roi_align_fused(feat, rois, 1 / 16.0, 7)
    return {"ms": cuda_ms(run, 50, 3), "device_us": device_us(run, "roi_align_kernel"),
            "host_us": host_us(run)}


def roi_times_line(t):
    dev = t["device_us"]
    return (f"{t['ms']:.4f} ms per call by events, device {dev} us, host {t['host_us']:.2f} "
            f"us per call, events / device {t['ms'] * 1e3 / dev if dev else float('nan'):.2f}")


def roi_cases(dev):
    """Phase 5's ROI-align inputs, in order: (tag, feat, rois). VGG-16's
    38x50x512 map at the search's R (8, 32, 64) and the detect head's 300,
    bf16 (H-first by the order rule), and f32 at 64 (W-first); ResNet-50's
    68x120x1024 C4 map of a 1088x1920 canvas (W-first, bf16) at its search's
    frontier capacities 8, 32 and 128."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(5)
    h, w, c = CANVAS[0] // 16, CANVAS[1] // 16, 512
    vgg = torch.relu(torch.randn((h, w, c), generator=g, device=dev)) * 20
    h, w, c = RESNET_CANVAS[0] // 16, RESNET_CANVAS[1] // 16, 1024
    res = (torch.relu(torch.randn((h, w, c), generator=g, device=dev)) * 20).to(torch.bfloat16)
    for dtype, r in ((torch.bfloat16, 8), (torch.bfloat16, 32), (torch.bfloat16, 64),
                     (torch.bfloat16, DETECT_ROIS), (torch.float32, 64)):
        yield "vgg16", vgg.to(dtype), detect_rois(r, r, dev)
    for r in (8, 32, 128):
        yield "resnet50", res, detect_rois(r, 100 + r, dev, RESNET_CANVAS)


def roi_times(dev, root):
    """``--roi-times [ROOT]``: the ROI-align kernel at phase 5's shapes,
    device time, CUDA-event time and host time per call, with the package
    found under ROOT (default: this checkout)."""
    for tag, feat, rois in roi_cases(dev):
        print(f"roi-times {root} {tag} {roi_case_name(feat, rois)}: "
              f"{roi_times_line(roi_kernel_times(feat, rois))}", flush=True)


def conv1_case(dev):
    """conv1_2's input at b=2 on the 608x800 canvas (post-ReLU-like bf16),
    its weights (OIHW bf16) and bias (bf16, as the trunk's)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(6)
    y = (torch.relu(torch.randn((BATCH,) + CANVAS + (64,), generator=g, device=dev)) * 30
         ).to(torch.bfloat16)
    w12 = (torch.randn((64, 64, 3, 3), generator=g, device=dev) * 0.06).to(torch.bfloat16)
    b12 = (torch.rand((64,), generator=g, device=dev) - 0.5).to(torch.bfloat16)
    return y, w12, b12


CONV1_FLOP = 2.0 * BATCH * CANVAS[0] * CANVAS[1] * 9 * 64 * 64
# The float32 kernel's three TF32 products for each of conv1's, at the TF32
# peak: its bound (0.435 ms), against the 1.070 ms of CONV1_FLOP at the f32
# CUDA-core peak that no kernel off the tensor cores can beat.
CONV1_F32_BOUND_MS = 3 * CONV1_FLOP / PEAK_OPS["tf32"] * 1e3
CONV1_F32_SIMT_MS = CONV1_FLOP / PEAK_OPS["f32"] * 1e3


def f32_shares(k_us):
    """The float32 conv1 kernel's device time as shares of the 3xTF32 bound
    and of the f32 CUDA-core bound, for a line."""
    return (f"{CONV1_F32_BOUND_MS / (k_us / 1e3):.1%} of the 3xTF32 bound "
            f"({CONV1_F32_BOUND_MS * 1e3:.1f} us), {CONV1_F32_SIMT_MS / (k_us / 1e3):.1%} of the "
            f"f32 CUDA-core bound ({CONV1_F32_SIMT_MS * 1e3:.1f} us)")


def phase5_kernels(dev):
    """The ROI-align and fused conv1 kernels alone at the slice's shapes,
    against their plain versions and a library yardstick the port never
    calls. Returns {kernel: {"err", "ms", "plain_ms", "library_ms",
    "bound"}}."""
    import torch
    import torch.nn.functional as F

    from aznet_tpu_torch.ops import conv1_fused as tconv1
    from aznet_tpu_torch.ops.cuda import conv1_kernel

    out = {}
    roi = {"err": 0.0}
    for tag, feat, rois in roi_cases(dev):
        rec = time_roi(feat, rois, tag)
        roi["err"] = max(roi["err"], rec["err"])
        check(rec["w_first"] == (feat.dtype == torch.float32 or tag == "resnet50"),
              "the order rule picked the other order")
        if tag == "vgg16" and feat.dtype == torch.bfloat16 and rois.shape[0] == DETECT_ROIS:
            # the record: the detect head's shape
            roi.update(ms=rec["ms"], device_us=rec["device_us"], plain_ms=rec["plain_ms"],
                       library_ms=rec["library_ms"], bound=rec["bound"])
    out["roi"] = roi

    y, w12, b12 = conv1_case(dev)
    w_k, bias = tconv1.kernel_layout(w12), b12.float()
    run = lambda: conv1_kernel.conv1_2_pool_cuda(y, w_k, bias)
    got = run()
    want = tconv1.conv1_2_pool_reference(y, w12, b12)
    torch.cuda.synchronize()
    ok, frac = tconv1.within_one_bf16_ulp(got, want)
    err = (got.float() - want.float()).abs().max().item()
    y_nchw, w_cl = y.permute(0, 3, 1, 2), w12.contiguous(memory_format=torch.channels_last)

    def library():
        return F.max_pool2d(torch.relu(F.conv2d(y_nchw, w_cl, b12, padding=1)), 2)

    def cudnn_conv():
        return F.conv2d(y_nchw, w_cl, b12, padding=1)

    k_ms = cuda_ms(run, 20, 3)
    p_ms = cuda_ms(lambda: tconv1.conv1_2_pool_reference(y, w12, b12), 3, 1)
    l_ms, c_ms = cuda_ms(library, 20, 3), cuda_ms(cudnn_conv, 20, 3)
    k_us, l_us, c_us = device_us(run, "conv1_fused_kernel"), device_us(library, ""), device_us(
        cudnn_conv, "")
    check(k_us is not None, "the profiler saw no conv1 kernel")
    nbytes = y.numel() * 2 + w12.numel() * 2 + 64 * 4 + got.numel() * 2
    b_ms, b_by = bound(nbytes, CONV1_FLOP, "bf16")
    tf = CONV1_FLOP / k_us / 1e6
    print(f"phase5 conv1_fused {BATCH}x{CANVAS[0]}x{CANVAS[1]}x64 bf16: max_abs_err {err}, "
          f"within one bf16 ulp {ok}, {frac:.4%} of elements differ, max |out| "
          f"{want.float().abs().max().item()}; kernel {k_ms:.4f} ms by events, device {k_us:.2f} "
          f"us ({tf:.1f} TFLOP/s, {tf / (PEAK_OPS['bf16'] / 1e12):.1%} of the bf16 peak), "
          f"plain {p_ms:.4f} ms, library (cuDNN conv2d + relu + max_pool2d) {l_ms:.4f} ms "
          f"(device {l_us} us), cuDNN conv2d alone {c_ms:.4f} ms (device {c_us} us, "
          f"{CONV1_FLOP / c_us / 1e6 if c_us else float('nan'):.1f} TFLOP/s), bound "
          f"{b_ms * 1e3:.2f} us ({b_by})", flush=True)
    check(ok, "conv1 kernel is more than one bf16 ulp from the plain version")
    out["conv1"] = {"err": err, "frac": frac, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                    "bound": (b_ms, b_by)}
    return out


def conv1_times(dev, root):
    """``--conv1-times [ROOT]``: the fused conv1 kernel alone at b=2 on the
    608x800 canvas (phase 5's input), device time and CUDA-event time, with
    the package found under ROOT (default: this checkout). Two checkouts run
    in turn inside one chip call compare two versions of the kernel."""
    from aznet_tpu_torch.ops import conv1_fused as tconv1
    from aznet_tpu_torch.ops.cuda import conv1_kernel

    y, w12, b12 = conv1_case(dev)
    pack = getattr(tconv1, "kernel_layout", None) or tconv1.kernel_weights  # older checkouts
    w_k, bias = pack(w12), b12.float()
    runs = [("bf16", lambda: conv1_kernel.conv1_2_pool_cuda(y, w_k, bias), "conv1_fused_kernel")]
    if hasattr(conv1_kernel, "conv1_2_pool_cuda_f32"):  # checkouts with the float32 kernel
        y32, w32 = y.float(), tconv1.kernel_layout_f32(w12.float())
        runs.append(("f32", lambda: conv1_kernel.conv1_2_pool_cuda_f32(y32, w32, bias),
                     "conv1_fused_f32_kernel"))
    for dtype, run, kernel in runs:
        (k_us, _), k_ms = launch_us(run, kernel), cuda_ms(run, 20, 3)
        check(k_us is not None, f"the profiler saw no {dtype} conv1 kernel")
        tf = CONV1_FLOP / k_us / 1e6
        share = (f32_shares(k_us) if dtype == "f32" else
                 f"{tf / (PEAK_OPS[dtype] / 1e12):.1%} of the {dtype} peak")
        print(f"conv1-times {root} {dtype} {BATCH}x{CANVAS[0]}x{CANVAS[1]}x64: device "
              f"{k_us:.2f} us ({tf:.1f} TFLOP/s, {share}), events {k_ms:.4f} ms", flush=True)


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
    im_detect, with the ROI-align, conv1, NMS and search launch counts
    reset just before and read just after and every kernel launch held
    against its plain version. Returns the counts, the kernels' errors on
    the path's inputs, and img/s."""
    import torch

    from aznet_tpu_torch import api, kernels
    from aznet_tpu_torch.ops.cuda import launch_counts, set_launch_counts

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

    names = ("roi_align", "conv1", "nms", "search_level", "search_select")
    with kernels.recording() as recorded:
        set_launch_counts(dict.fromkeys(names, 0))
        p_boxes, p_scores, p_valid, d_scores, d_boxes = fused(images, src_hw, scales)
        t_scores, t_boxes = detect(images, src_hw, scales, p_boxes)
        props = api.im_propose(az, ims_np[0])
        s1, b1 = api.im_detect(fr, ims_np[0], props)
        torch.cuda.synchronize()
        now = launch_counts()
        counts = {k: now[k] for k in names}
    print(f"phase6 main path: launches {counts}", flush=True)
    n_iter = max(int(cfg.TEST.BBOX_ITER), 1)
    searches, detects, trunk_calls = BATCH + 1, 2 * BATCH + 1, 4
    check(counts["conv1"] == trunk_calls, f"conv1 kernel launched {counts['conv1']} times in "
          f"{trunk_calls} trunk calls")
    check(counts["roi_align"] >= searches + n_iter * detects,
          f"ROI-align kernel launched {counts['roi_align']} times")
    check(counts["nms"] >= searches, f"NMS kernel launched {counts['nms']} times")
    check(counts["search_level"] >= searches,
          f"search-level kernel launched {counts['search_level']} times in {searches} searches")
    check(counts["search_select"] >= 3 * searches and counts["search_select"] % 3 == 0,
          f"search seed and selection kernels launched {counts['search_select']} times in "
          f"{searches} or more searches")

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

    errs = hold("phase6", recorded)
    check(errs.keys() >= {"roi_align", "conv1", "search_level"},
          f"phase6: a kernel of the path was not recorded: {sorted(errs)}")
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
    from aznet_tpu_torch.ops.cuda import launch_counts

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
    before = launch_counts()
    got = api.im_detect(gpu_net, im, boxes)
    after = launch_counts()
    launched = tuple(after[k] - before[k] for k in ("roi_align", "conv1"))
    want = api.im_detect(cpu_net, im, boxes)
    d_s = float(np.abs(got[0] - want[0]).max())
    d_b = float(np.abs(got[1] - want[1]).max())
    print(f"phase6 reference (VGG-16 WIDTH 0.25 bf16, card vs CPU): max |d score| {d_s:.3g}, "
          f"max |d box| {d_b:.3g}; launches (roi_align, conv1) {launched}", flush=True)
    check(launched == (1, 1), f"the small config did not run both kernels: {launched}")
    check(d_s <= 1e-2 and d_b <= 0.5, "card and CPU detections disagree")


def iou_inputs(seed, n, k):
    """Boxes in [0, 1000] plus wh in [0, 200], one box in 16 of each side
    degenerate (wh -1, -0.5 or -30: zero, small or negative area with offset
    1); row 0 with a negative area (union < 0 with every column), row 1 and
    column 0 with zero area (union 0 between them)."""
    rng = np.random.RandomState(seed)
    out = []
    for m in (n, k):
        xy = rng.uniform(0, 1000, (m, 2))
        wh = rng.uniform(0, 200, (m, 2))
        bad = rng.rand(m) < 1 / 16
        wh[bad] = rng.choice([-1.0, -0.5, -30.0], (int(bad.sum()), 2))
        out.append(np.concatenate([xy, xy + wh], 1).astype(np.float32))
    out[0][0] = [0.0, 500.0, 1000.0, 0.0]
    if n > 1:
        out[0][1] = [500.0, 500.0, 499.0, 499.0]
    out[1][0] = [10.0, 10.0, 9.0, 9.0]
    return out


# Phase 7's (N, K): check_iou's, test_pallas's, the NMS candidates', 4096 x
# 4096; K % 4 != 0 (the kernel's element-wise body), one row, one box.
IOU_SHAPES = ((300, 200), (50, 40), (128, 128), (200, 300), (2048, 2048), (4096, 4096),
              (300, 201), (50, 41), (129, 130), (2047, 2049), (4096, 4095), (1, 1), (1, 4096))
IOU_TALL = (2_100_000, 3)  # above the 65,535 x 32 rows the old 2-D grid allowed


def iou_bound(n, k):
    """Both box sets read once, the ``[N, K]`` f32 matrix written once;
    :data:`IOU_OPS` f32 operations per pair."""
    return bound((n + k) * 16 + n * k * 4, n * k * IOU_OPS, "f32")


def iou_case(dev, n, k):
    import torch

    return [torch.from_numpy(x).to(dev) for x in iou_inputs(n + k, n, k)]


def iou_kernel_times(a, b):
    """``bbox_overlaps_cuda`` at offset 1 on the card, timed: {"ms": CUDA
    events per call over back-to-back calls, "device_us", "host_us": the
    host's time per call}."""
    from aznet_tpu_torch.ops.cuda import iou_kernel

    run = lambda: iou_kernel.bbox_overlaps_cuda(a, b, 1.0)
    return {"ms": cuda_ms(run, 50, 3), "device_us": device_us(run, "iou_kernel"),
            "host_us": host_us(run)}


def iou_times_line(t, n, k):
    dev = t["device_us"]
    return (f"device {dev} us ({n * k * 4 / dev / 1e6 if dev else float('nan'):.3f} TB/s "
            f"written), events {t['ms']:.4f} ms, host {t['host_us']:.2f} us per call")


def phase7_iou(dev):
    """The IoU kernel alone (``csrc/iou.cu``; no main path calls it, as no
    path of the JAX package calls ``bbox_overlaps_pallas``), bit for bit
    against its plain version at offsets 1 and 0 at :data:`IOU_SHAPES` and
    :data:`IOU_TALL`, each timed beside the plain version, its bound and a
    yardstick of the card's write rate: ``zero_()`` of an ``[N, K]`` float32
    tensor, which computes no IoU and which the port never calls. Returns
    {"err", "ms", "device_us", "plain_ms", "bound"}, times at 4096 x 4096."""
    import torch

    from aznet_tpu_torch.ops.cuda import iou_kernel
    from aznet_tpu_torch.ops.iou import bbox_overlaps

    err, rec = 0.0, {}
    for n, k in IOU_SHAPES + (IOU_TALL,):
        a, b = iou_case(dev, n, k)
        for offset in (1.0, 0.0):
            got = iou_kernel.bbox_overlaps_cuda(a, b, offset)
            want = bbox_overlaps(a, b, offset)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            err = max(err, e)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"IoU kernel disagrees with the plain version at {n}x{k}, offset {offset}")
        t = iou_kernel_times(a, b)
        p_ms = cuda_ms(lambda: bbox_overlaps(a, b, 1.0), 10, 2)
        out = torch.empty((n, k), dtype=torch.float32, device=dev)
        fill = device_times(out.zero_, ["elementwise_kernel", "Memset"])
        zero_us = fill and sum(fill.values())
        b_ms, b_by = iou_bound(n, k)
        print(f"phase7 iou {n}x{k}: max_abs_err {e}, zeros {(want == 0).float().mean().item():.4f}"
              f", max {want.max().item():.6f}; kernel {iou_times_line(t, n, k)}; plain "
              f"{p_ms:.4f} ms; bound {b_ms * 1e3:.3f} us ({b_by}), device / bound "
              f"{t['device_us'] / (b_ms * 1e3) if t['device_us'] else float('nan'):.2f}; "
              f"yardstick out.zero_() device {zero_us} us", flush=True)
        check(bool((want[0] == 0).all()), f"{n}x{k}: row 0's union is < 0, its IoUs 0")
        check(want.max().item() > 0 or min(n, k) == 1, f"{n}x{k}: no overlapping pair")
        if (n, k) == (4096, 4096):
            rec = {"ms": t["ms"], "device_us": t["device_us"], "plain_ms": p_ms,
                   "bound": (b_ms, b_by)}
    rec["err"] = err
    return rec


def sass_loop(lib, name):
    """{function: (instructions, bytes stored)} of the innermost loop that
    stores to global memory, in each kernel of the library ``lib`` whose
    name holds ``name``, read from ``cuobjdump -sass``; also the SASS of
    those kernels as text. A loop is the span from a backward branch's
    target to the branch."""
    import re
    from pathlib import Path

    from aznet_tpu_torch import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr.strip()}")
    funcs, cur, text = {}, None, []
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), []) if name in m.group(1) else None
        if cur is None:
            continue
        text.append(line)
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            cur.append((int(m.group(1), 16), m.group(2)))

    def stored(ins):
        op = next(t for t in ins.split() if not t.startswith("@"))
        return (16 if ".128" in op else 8 if ".64" in op else 4) if op.startswith("STG") else 0

    loops = {}
    for fn, ins in funcs.items():
        spans = []
        for at, op in ins:
            m = re.search(r"\bBRA\S*\s+(?:.*\s)?(0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) <= at:
                body = [o for a, o in ins if int(m.group(1), 16) <= a <= at]
                if sum(map(stored, body)):
                    spans.append((len(body), sum(map(stored, body))))
        loops[fn] = min(spans) if spans else None
    return loops, "\n".join(text)


def search_level_inputs(r, next_cap, dev, seed=0):
    """One search level's inputs at R regions of a 600x800 image, from the
    card tests' generator (``tests/_search_level_cases.py::level_case``):
    the head's logits as strided views of its fused output, the frontier,
    the constants at VGG-16's SEAR, and a candidate buffer of R * K rows."""
    import torch
    from pathlib import Path

    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    from _search_level_cases import level_case

    out, f_boxes, f_valid, _, consts = level_case("random", r, seed, dev)
    n = r * out["adj_score"].shape[1]
    return (out, f_boxes, f_valid, next_cap, consts, torch.zeros((n, 4), device=dev),
            torch.zeros(n, device=dev), 0)


def search_level_bound(r, k, next_cap):
    """The head's logits, the frontier and the extent read once, the
    candidates and the next frontier written once; per candidate the
    anchor (14 f32 operations), decode (28), clip (8) and sigmoid (4), per
    child its sigmoid, box, sides and gate (25), one a compare-exchange of
    the sort over its width, the next frontier's boxes (14 a slot)."""
    from aznet_tpu_torch.ops.cuda.search_level_kernel import sort_width

    width = sort_width(r, next_cap)
    stages = width.bit_length() - 1
    nbytes = r * (1 + 5 * k) * 4 + r * 17 + 8 + r * k * 20 + next_cap * 17
    ops = r * k * 54 + 5 * r * 25 + width // 2 * stages * (stages + 1) // 2 + next_cap * 14
    return bound(nbytes, ops, "f32")


def search_level_timing(dev, r, next_cap, seed=0):
    """One search level after the head at (R, next_cap), the kernel
    (``level_cuda``) and the plain version on the card (``level_plain``),
    first held bit for bit. Returns {"kernel" | "plain": {"device_us": the
    card's events a call (kernels, copies, fills), "launches": events a
    call, "ms": CUDA-event time a call over back-to-back calls, "host_us":
    the host's time a call}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aznet_tpu_torch.search import propose

    args = search_level_inputs(r, next_cap, dev, seed)
    out, f_boxes, f_valid, _, consts, cand_b, cand_s, _ = args
    bufs = [(torch.full_like(cand_b, 7.0), torch.full_like(cand_s, 7.0)) for _ in range(2)]
    got = (*bufs[0], *propose.level_cuda(out, f_boxes, f_valid, next_cap, consts, *bufs[0], 0))
    want = (*bufs[1], *propose.level_plain(out, f_boxes, f_valid, next_cap, consts, *bufs[1], 0))
    for g, w in zip(got, want):
        check(torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                          w.view(torch.int32) if w.dtype == torch.float32 else w),
              f"search-level kernel differs from the plain version at R={r}, next_cap={next_cap}")
    res = {}
    for name, fn in (("kernel", propose.level_cuda), ("plain", propose.level_plain)):
        run = lambda: fn(*args)  # noqa: E731
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                run()
            torch.cuda.synchronize()
        events = [e.duration_ns() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
        res[name] = {"device_us": sum(events) / 20 / 1e3, "launches": len(events) / 20,
                     "ms": cuda_ms(run, 100, 3), "host_us": host_us(run, 100)}
    return res


def search_level_line(tag, r, next_cap, t):
    b_ms, b_by = search_level_bound(r, 11, next_cap)
    return (f"{tag} R={r} next_cap={next_cap}: " + "; ".join(
        f"{name} device {v['device_us']:.2f} us in {v['launches']:.1f} launches, "
        f"{v['ms']:.4f} ms per call by events, host {v['host_us']:.2f} us per call"
        for name, v in t.items()) + f"; bound {b_ms * 1e3:.4f} us ({b_by})")


def search_level_times(dev, root):
    """``--search-level-times [ROOT]``: :func:`search_level_timing` at the
    benchmark configurations' (R, next_cap). Needs a checkout with the
    kernel (``search/propose.py::level_cuda``)."""
    for r, next_cap in SEARCH_LEVEL_STEPS:
        print(search_level_line(f"search-level-times {root}", r, next_cap,
                                search_level_timing(dev, r, next_cap)), flush=True)


def phase5_search_level(dev):
    """The search-level kernel alone at R = 64 and 128 (next_cap = R), bit
    for bit against the plain version on the card and timed beside it.
    Returns {R: :func:`search_level_timing`'s result}."""
    out = {}
    for r in (64, 128):
        out[r] = search_level_timing(dev, r, r, seed=r)
        print(search_level_line("phase5 search level", r, r, out[r]), flush=True)
    return out


def search_select_inputs(config, dev):
    """The seed's and the selection's arguments of one search at a benchmark
    configuration's SEAR and image (``tests/_search_level_cases.py``): the
    extents as int32 card tensors, as the preprocess hands them over, and the
    candidate buffer of a whole search with the stand-in head."""
    import torch
    from pathlib import Path

    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    from _search_level_cases import K, SEARCH_CONFIGS, stand_in_head

    from aznet_tpu_torch.search import propose

    scfg, (h, w) = SEARCH_CONFIGS[config]
    hw = tuple(torch.tensor(v, dtype=torch.int32, device=dev) for v in (h, w))
    feat = torch.zeros((h // 16, w // 16, 8), device=dev)
    c_boxes, c_scores = propose.search_candidates(stand_in_head(), feat, hw, scfg, K)
    seed = (hw, scfg, 1.0, propose.frontier_schedule(scfg)[0],
            propose.candidate_starts(scfg, K)[1], dev)
    return seed, (c_boxes, c_scores, scfg, 1.0)


def search_select_timing(dev, config):
    """The search's seed and its selection at a benchmark configuration, the
    kernels (``propose.seed_cuda``, ``select_cuda``) and the plain versions
    on the card (``seed_plain``, ``select_plain``; both selections run the
    NMS kernel), first held bit for bit. Returns {(part, "kernel" |
    "plain"): {"device_us": the card's events a call, "launches": kernels a
    call, "copies": copies and fills by the copy engine a call, "ms":
    CUDA-event time a call over back-to-back calls, "host_us": the host's
    time a call}}, part "seed" or "select"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aznet_tpu_torch.kernels import equal_bits
    from aznet_tpu_torch.search import propose

    res = {}
    for part, args in zip(("seed", "select"), search_select_inputs(config, dev)):
        fns = {"kernel": getattr(propose, f"{part}_cuda"),
               "plain": getattr(propose, f"{part}_plain")}
        for g, w in zip(fns["kernel"](*args), fns["plain"](*args)):
            check(equal_bits(g, w)[0], f"search {part} kernel differs from the plain version "
                                       f"at {config}")
        for name, fn in fns.items():
            run = lambda: fn(*args)  # noqa: E731
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    run()
                torch.cuda.synchronize()
            events = [(e.name(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA]
            copies = sum(n.startswith(("Memcpy", "Memset")) for n, _ in events)
            res[part, name] = {"device_us": sum(d for _, d in events) / 20 / 1e3,
                               "launches": (len(events) - copies) / 20, "copies": copies / 20,
                               "ms": cuda_ms(run, 100, 3), "host_us": host_us(run, 100)}
    return res


def search_select_lines(tag, config, t):
    return [f"{tag} {config} {part}: " + "; ".join(
        f"{name} device {v['device_us']:.2f} us in {v['launches']:.1f} launches and "
        f"{v['copies']:.1f} copies, {v['ms']:.4f} ms per call by events, host "
        f"{v['host_us']:.2f} us per call"
        for (p, name), v in t.items() if p == part) for part in ("seed", "select")]


def search_select_times(dev, root):
    """``--search-select-times [ROOT]``: :func:`search_select_timing` at
    both benchmark configurations. Needs a checkout with the kernels
    (``search/propose.py::seed_cuda`` and ``select_cuda``)."""
    for config in ("vgg16", "resnet50_1080p"):
        for line in search_select_lines(f"search-select-times {root}", config,
                                        search_select_timing(dev, config)):
            print(line, flush=True)


def phase5_search_select(dev):
    """The seed and selection kernels alone at both benchmark
    configurations, bit for bit against the plain versions on the card and
    timed beside them. Returns {config: :func:`search_select_timing`'s
    result}."""
    out = {}
    for config in ("vgg16", "resnet50_1080p"):
        out[config] = search_select_timing(dev, config)
        for line in search_select_lines("phase5 search select", config, out[config]):
            print(line, flush=True)
    return out



FROZEN_BN_BATCH = 4  # the resnet50_1080p cell's call: 4 frames on a 1088x1920 canvas


def card_ops(fn, iters):
    """The CUDA events of ``iters`` calls of ``fn`` under ``torch.profiler``,
    in the order they started: ``[(name, microseconds)]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = sorted((e.start_ns(), e.name(), e.duration_ns() / 1e3)
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA)
    return [(name, us) for _, name, us in events]


def frozen_bn_timing(dev):
    """The frozen BatchNorm epilogues of one bf16 ResNet-50 trunk call at the
    ``resnet50_1080p`` cell's shapes (4 frames on 1088x1920; seeded weights,
    scales 1 + 0.1 N), recorded through the kernel table and held bit for
    bit against the plain version. Then, inside whole trunk calls (each
    epilogue reading the conv output the conv just wrote, as on the path;
    alone, a small output stays in L2 and reads faster than the memory), each
    launch's device time (``torch.profiler``, the median of 3 calls) beside
    its bytes bound, and the plain chain's elementwise device time and
    launches in its place (the elementwise kernels of a call with it, less
    those of a call with the kernel); each launch's host time alone; the
    trunk call with the kernel and with the plain chain in alternating
    rounds (CUDA events, medians of 3), and each one's peak memory."""
    import torch

    from aznet_tpu_torch import kernels
    from aznet_tpu_torch.models.resnet import ResNet50Trunk
    from aznet_tpu_torch.ops import frozen_bn
    from aznet_tpu_torch.ops.cuda import frozen_bn_kernel

    g = torch.Generator(dev).manual_seed(25)
    trunk = ResNet50Trunk(dtype=torch.bfloat16).to(dev)
    with torch.no_grad():
        for name, p in trunk.named_parameters():
            r = torch.randn(p.shape, generator=g, device=dev)
            p.copy_(r / p[0].numel() ** 0.5 if p.ndim == 4
                    else 1 + 0.1 * r if name.endswith("scale") else 0.1 * r)
    trunk = trunk.to(torch.bfloat16)
    x = 128 * (2 * torch.rand((FROZEN_BN_BATCH,) + RESNET_CANVAS + (3,), generator=g,
                              device=dev) - 1)
    kernel = frozen_bn_kernel.frozen_bn_relu_cuda

    @contextlib.contextmanager
    def plain_chain():
        frozen_bn_kernel.frozen_bn_relu_cuda = frozen_bn.frozen_bn_relu_reference
        try:
            yield
        finally:
            frozen_bn_kernel.frozen_bn_relu_cuda = kernel

    with torch.inference_mode():
        with kernels.recording(["frozen_bn"]) as recs:
            trunk(x)
            torch.cuda.synchronize()
        check(len(recs) == 40, f"{len(recs)} frozen BatchNorm launches in a trunk call, not 40")
        held = kernels.held(recs)["frozen_bn"]
        check(held["ok"], "the frozen BatchNorm kernel differs from its plain version")
        shapes = []
        for rec in recs:
            y = rec.args[0].clone(memory_format=torch.channels_last)
            rest = rec.args[1:]
            form = 0 if rest[2] is None else 1 if rest[3] is None else 2
            shapes.append({"shape": tuple(y.shape), "form": form,
                           "bound_us": (2 + (form > 0)) * y.numel() * y.element_size()
                           / HBM_BYTES_PER_S * 1e6,
                           "host_us": host_us(lambda: kernel(y, *rest), 40)})
        del recs, y, rest
        ops = card_ops(lambda: trunk(x), 3)
        mine = [us for name, us in ops if "frozen_bn_epilogue" in name]
        check(len(mine) == 3 * 40, f"{len(mine)} epilogue launches profiled in 3 trunk calls")
        for i, t in enumerate(shapes):
            t["device_us"] = float(np.median(mine[i::40]))
        with plain_chain():
            plain_ops = card_ops(lambda: trunk(x), 3)
        elementwise = [[us for name, us in o if "elementwise_kernel" in name]
                       for o in (ops, plain_ops)]
        trunk_ms, peak = {"kernel": [], "plain": []}, {}
        for _ in range(3):
            for side in ("kernel", "plain"):
                with plain_chain() if side == "plain" else contextlib.nullcontext():
                    trunk_ms[side].append(cuda_ms(lambda: trunk(x), 5, 2))
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    trunk(x)
                    torch.cuda.synchronize()
                    peak[side] = torch.cuda.max_memory_allocated()
    tot = {k: sum(t[k] for t in shapes) for k in ("device_us", "bound_us", "host_us")}
    tot["plain_device_us"] = (sum(elementwise[1]) - sum(elementwise[0])) / 3
    tot["plain_launches"] = (len(elementwise[1]) - len(elementwise[0])) / 3
    return {"shapes": shapes, "sum": tot, "host_us_max": max(t["host_us"] for t in shapes),
            "trunk_ms": {k: float(np.median(v)) for k, v in trunk_ms.items()},
            "trunk_ms_rounds": trunk_ms, "peak_bytes": peak, "err": held["err"]}


def frozen_bn_lines(tag, t):
    lines = [f"{tag} {s['shape']} form {s['form']}: device {s['device_us']:.2f} us in the "
             f"trunk (bound {s['bound_us']:.2f} us, {s['bound_us'] / s['device_us']:.1%}), "
             f"host {s['host_us']:.2f} us" for s in t["shapes"]]
    s, tr = t["sum"], t["trunk_ms"]
    lines.append(
        f"{tag} trunk call of {FROZEN_BN_BATCH}: kernel {s['device_us']:.1f} us of device time in "
        f"40 launches against a bound of {s['bound_us']:.1f} us "
        f"({s['bound_us'] / s['device_us']:.1%} of the bytes bound, "
        f"{s['device_us'] / s['bound_us']:.3f}x), host {s['host_us']:.1f} us "
        f"({s['host_us'] / 40:.2f} us a call, at most {t['host_us_max']:.2f}); plain chain "
        f"{s['plain_device_us']:.1f} us in {s['plain_launches']:.1f} more elementwise launches; "
        f"trunk {tr['kernel']:.3f} ms with the kernel, {tr['plain']:.3f} ms with the plain chain "
        f"({tr['kernel'] / FROZEN_BN_BATCH:.3f} and {tr['plain'] / FROZEN_BN_BATCH:.3f} ms an "
        f"image; rounds {t['trunk_ms_rounds']}); peak {t['peak_bytes']}; max_abs_err {t['err']}")
    return lines


def frozen_bn_times(dev, root):
    """``--frozen-bn-times [ROOT]``: :func:`frozen_bn_timing`. Needs a
    checkout with the kernel (``ops/frozen_bn.py``)."""
    for line in frozen_bn_lines(f"frozen-bn-times {root}", frozen_bn_timing(dev)):
        print(line, flush=True)


def phase5_frozen_bn(dev):
    """The frozen BatchNorm kernel alone at a ResNet-50 trunk call's 40
    epilogues of the ``resnet50_1080p`` cell, bit for bit and timed
    (:func:`frozen_bn_timing`)."""
    out = frozen_bn_timing(dev)
    for line in frozen_bn_lines("phase5 frozen bn", out):
        print(line, flush=True)
    return out

def iou_times(dev, root):
    """``--iou-times [ROOT]``: the IoU kernel at phase 7's shapes
    (:data:`IOU_SHAPES`), device, CUDA-event and host time per call, with
    the package found under ROOT (default: this checkout); then its loop's
    SASS instructions per pair (``cuobjdump``), the SASS itself written to
    ``build/iou_sass_<ROOT>.txt``; then the two largest shapes again in four
    sessions each."""
    from pathlib import Path

    from aznet_tpu_torch import _build
    from aznet_tpu_torch.ops.cuda import iou_kernel

    for n, k in IOU_SHAPES:
        print(f"iou-times {root} {n}x{k}: {iou_times_line(iou_kernel_times(*iou_case(dev, n, k)), n, k)}",
              flush=True)
    loops, text = sass_loop(_build.build(), "iou_kernel")
    for fn, loop in loops.items():
        print(f"iou-times {root} sass {fn}: " + (
            f"loop of {loop[0]} instructions storing {loop[1]} bytes, "
            f"{loop[0] / (loop[1] / 4):.2f} instructions per pair" if loop else "no storing loop"))
    out = Path(__file__).resolve().parent / "build"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"iou_sass_{root.strip('./').replace('/', '_') or 'checkout'}.txt").write_text(text)
    # Whether a large shape's time holds within one process: four sessions
    # each, every session's outputs at a new address (the last one is held).
    held = []
    for n, k in ((4096, 4095), (4096, 4096)):
        a, b = iou_case(dev, n, k)
        run = lambda: iou_kernel.bbox_overlaps_cuda(a, b, 1.0)
        for i in range(4):
            held.append(run())
            addr = run().data_ptr()  # freed at once: the session's calls reuse it
            print(f"iou-times {root} repeat {n}x{k} session {i}: output at {addr:#x}, "
                  f"device {device_us(run, 'iou_kernel')} us", flush=True)


def cfg_file(name, **model):
    """``experiments/cfgs/<name>.yml`` through the port's ``cfg_from_file``,
    then ``MODEL`` overrides."""
    from pathlib import Path

    from aznet_tpu_torch.config import Config, cfg_from_dict, cfg_from_file

    path = Path(__file__).resolve().parent / "experiments" / "cfgs" / f"{name}.yml"
    return cfg_from_dict(cfg_from_file(Config(), str(path)), {"MODEL": model})



def propose_phase(dev, tag, net, raw_hw, canvas):
    """The propose path of ``net`` (``POOLING_MODE='align_pallas'``) with the
    ROI-align and frozen BatchNorm launch counts reset just before and read
    just after, beside phase 2's. Returns phase 2's result and the ROI-align launches' modes
    {(dtype, feature shape, P, order)}."""
    records = []
    p = phase2_propose(dev, net, tag, counters=("roi_align", "frozen_bn"), raw_hw=raw_hw,
                       canvas=canvas, records=records)
    levels = net.cfg.SEAR.MAX_LEVELS
    check(p["launches"]["roi_align"] >= BATCH + 1, f"ROI-align kernel launched "
          f"{p['launches']['roi_align']} times in {BATCH + 1} searches of up to {levels} levels")
    rois = [r.args for r in records if r.name == "roi_align"]
    modes = {(str(feat.dtype)[6:], tuple(feat.shape), pool, "W-first" if w_first else "H-first")
             for feat, _, _, pool, w_first in rois}
    print(f"{tag} ROI align on the path's {len(rois)} inputs (R in "
          f"{sorted({int(a[1].shape[0]) for a in rois})}; {sorted(modes)}): kernel vs plain "
          f"max_abs_err {p['err']['roi_align']}", flush=True)
    return {**p, "modes": modes}


def card_vs_cpu(tag, cfg, dev, int8=False):
    """A small config of the same trunk on the card against the port on the
    CPU, same seeded weights, f32 under PyTorch's default flags (the port
    scopes its own float32 precision): trunk features to 1e-4 of max |x|; im_propose on a 96x128 image: the same count, the sorted scores to
    1e-4, at least 90% of the boxes within 0.01 px of a CPU box (near-ties of
    the random head may swap at the cut). ``int8``: the int8 trunk, with
    scales calibrated on the CPU on the same input, features to a cosine of
    0.999 (its bf16 convs round apart on the two devices, and a value near a
    quantization boundary may take the other code)."""
    import torch

    from aznet_tpu_torch import api
    from aznet_tpu_torch.config import cfg_from_dict
    from aznet_tpu_torch.ops.quant import calibrate_trunk_int8_resnet, with_int8_scales

    small = cfg_from_dict(cfg, {
        "MODEL": {"FC_DIM": 64, "FC7_DIM": 0, "COMPUTE_DTYPE": "float32"},
        "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 256, "MAX_LEVELS": 3, "NUM_PROPOSALS": 50},
        "TEST": {"SCALES": (64,), "MAX_SIZE": 128}})
    cpu_net = api.build_az_net(small, device="cpu")
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.uniform(-120, 120, (1, 64, 96, 3)).astype(np.float32))
    if int8:
        small = with_int8_scales(small, calibrate_trunk_int8_resnet(cpu_net, x.numpy()))
        cpu_net = api.build_az_net(small, state_dict=cpu_net.params, device="cpu")
    gpu_net = api.build_az_net(small, state_dict=cpu_net.params, device=dev)
    with torch.inference_mode():
        want = cpu_net.model.features(x).float()
        got = gpu_net.model.features(x.to(dev)).float().cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    cos = (got * want).sum().item() / max(got.norm().item() * want.norm().item(), 1e-30)
    line = (f"{tag} reference ({small.MODEL.BACKBONE} {small.MODEL.COMPUTE_DTYPE}, card vs CPU): "
            f"trunk max rel err {rel:.3g}, cosine {cos:.7f}")
    check(cos >= 0.999 if int8 else rel <= 1e-4, f"{tag}: card and CPU trunks disagree")
    if not int8:
        im = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
        p_gpu, p_cpu = api.im_propose(gpu_net, im), api.im_propose(cpu_net, im)
        check(p_gpu.shape == p_cpu.shape, f"{tag}: card {p_gpu.shape} vs CPU {p_cpu.shape}")
        d_s = float(np.abs(np.sort(p_gpu[:, 4]) - np.sort(p_cpu[:, 4])).max())
        near = float((np.abs(p_gpu[:, None, :4] - p_cpu[None, :, :4]).max(-1).min(-1)
                      <= 1e-2).mean())
        line += f"; {p_gpu.shape[0]} proposals, max |d score| {d_s:.3g}, {near:.3f} of boxes match"
        check(d_s <= 1e-4 and near >= 0.9, f"{tag}: card and CPU proposals disagree")
    print(line, flush=True)


def phase8_resnet(dev):
    """ResNet-50 at 1080p (``experiments/cfgs/resnet50_1080p.yml``): the bf16
    propose path, then int8 from the same float32 weights, calibrated on two
    random canvases at batch 1, with ``INT8_ROI``; each with
    ``POOLING_MODE='align_pallas'`` and both kernels held on the path's own
    inputs; then the int8 path with the einsum ``'align'`` (where
    ``INT8_ROI`` quantizes the C4 map) once, the einsum ROI align on the
    1080p map on the card against the CPU, and the trunk on the card against
    the CPU at a small image."""
    import dataclasses

    import torch

    from aznet_tpu_torch import api
    from aznet_tpu_torch.ops import roi_pool as troi
    from aznet_tpu_torch.ops.quant import (calibrate_head_int8, calibrate_trunk_int8_resnet,
                                           with_int8_scales)

    raw_hw, canvas = RESNET_RAW_HW, RESNET_CANVAS
    cfg = cfg_file("resnet50_1080p", POOLING_MODE="align_pallas")
    check(api._canvas_for(*raw_hw, cfg) == canvas, "the 1080p canvas is not 1088x1920")
    net = build_net("phase8", cfg, dev)
    out = {"bf16": propose_phase(dev, "phase8 bf16", net, raw_hw, canvas)}
    # A trunk call runs the stem's epilogue and three a block; the path makes
    # two (the batch, then im_propose's image).
    check(out["bf16"]["launches"]["frozen_bn"] == 2 * 40 and "frozen_bn" in out["bf16"]["err"],
          f"frozen BatchNorm launches {out['bf16']['launches']['frozen_bn']} on the bf16 "
          f"path, not 80")
    check(("bfloat16", (canvas[0] // 16, canvas[1] // 16, 1024), 7, "W-first")
          in out["bf16"]["modes"], "the 68x120x1024 bf16 map did not take the W-first order")

    t0 = time.perf_counter()
    calib = np.random.RandomState(7).randint(0, 256, (2,) + canvas + (3,)).astype(np.float32)
    calib -= np.asarray(cfg.PIXEL_MEANS, np.float32)
    scales = calibrate_trunk_int8_resnet(net, calib, batch_size=1)
    head_scales = calibrate_head_int8(net, calib, scales, batch_size=1)
    torch.cuda.synchronize()
    print(f"phase8 calibration: {time.perf_counter() - t0:.2f} s; {len(scales)} trunk scales "
          f"(first {[round(s, 6) for s in scales[:4]]}, output {scales[-1]:.6f}), head scales "
          f"{[round(s, 6) for s in head_scales]}", flush=True)
    cfg8 = with_int8_scales(cfg, scales, head_scales)
    cfg8 = dataclasses.replace(cfg8, MODEL=dataclasses.replace(cfg8.MODEL, INT8_ROI=True))
    net8 = build_net("phase8 int8", cfg8, dev, state_dict=net.params)
    out["int8"] = propose_phase(dev, "phase8 int8", net8, raw_hw, canvas)
    check(out["int8"]["launches"]["frozen_bn"] == 2 * 40,
          f"frozen BatchNorm launches {out['int8']['launches']['frozen_bn']} on the int8 "
          f"path, not 80")
    blobs = out["bf16"]["blobs"]
    with torch.inference_mode():
        f16 = net.model.features(blobs).float()
        f8 = net8.model.features(blobs).float()
    cos = (f16 * f8).sum().item() / max(f16.norm().item() * f8.norm().item(), 1e-9)
    print(f"phase8 int8 vs bf16 trunk features: cosine {cos:.6f}; img/s at b={BATCH}: int8 "
          f"{out['int8']['ips']:.2f} vs bf16 {out['bf16']['ips']:.2f} (same call)", flush=True)
    check(cos > 0.98, f"int8 ResNet-50 features drift from the bf16 trunk: cosine {cos}")
    del net8

    # The int8 ROI path: 'align' with INT8_ROI quantizes the 68x120 C4 map.
    cfg8a = dataclasses.replace(cfg8, MODEL=dataclasses.replace(cfg8.MODEL,
                                                                POOLING_MODE="align"))
    net8a = build_net("phase8 int8 align", cfg8a, dev, state_dict=net.params)
    im = np.random.RandomState(0).randint(0, 256, raw_hw + (3,)).astype(np.uint8)
    dets = api.im_propose(net8a, im)
    check(dets.ndim == 2 and 1 <= dets.shape[0] <= cfg.SEAR.NUM_PROPOSALS
          and np.isfinite(dets).all(), f"int8 'align' im_propose gave {dets.shape}")
    print(f"phase8 int8 'align' + INT8_ROI im_propose: {dets.shape[0]} proposals", flush=True)
    del net8a

    # The einsum 'align' on the 1080p map (W-first by its rule), card vs CPU.
    with torch.inference_mode():
        feat = net.model.features(blobs[:1])[0]
    h, w, c = feat.shape
    wf = troi._contract_w_first(h, w, c, feat.element_size())
    rng = np.random.RandomState(9)
    xy = rng.uniform(0, (canvas[1] - 32, canvas[0] - 32), (32, 2))
    rois = np.concatenate([xy, np.minimum(xy + rng.uniform(16, 900, (32, 2)),
                                          (canvas[1] - 1, canvas[0] - 1))], 1)
    rois = torch.from_numpy(rois.astype(np.float32))
    got = troi.roi_align(feat, rois.to(dev), 1 / 16.0, 7).float().cpu()
    want = troi.roi_align(feat.cpu(), rois, 1 / 16.0, 7).float()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    print(f"phase8 einsum 'align' on {h}x{w}x{c} bf16 ({'W' if wf else 'H'}-first), R=32, "
          f"card vs CPU: max rel err {rel:.3g}", flush=True)
    check(wf and rel <= 1e-2, "the einsum ROI align on the 1080p map: order or values off")
    del net, feat
    torch.cuda.empty_cache()

    card_vs_cpu("phase8", cfg_file("resnet50_1080p", STEM_S2D=False), dev)
    card_vs_cpu("phase8 int8", cfg_file("resnet50_1080p", STEM_S2D=False), dev, int8=True)
    return out


C4_BATCH, C4_BOXES = 8, 300  # resnet101_c4.detect_given_b8: 8 images a call, 300 boxes each
# resnet101_fpn.detect_coco_b4: 4 raw 480x640 images a call on the 800x1088
# canvas, 1000 boxes each, pooled from P2-P5.
FPN_BATCH, FPN_BOXES, FPN_RAW_HW, FPN_CANVAS = 4, 1000, (480, 640), (800, 1088)
FPN_LEVELS = tuple((FPN_CANVAS[0] // s, FPN_CANVAS[1] // s, 256) for s in (4, 8, 16, 32))


def c4_config():
    """The C4 detector at ``benchmark/configs/resnet101_c4.json``'s
    settings: bf16 (``Config()``'s), ROI align to 14 through the kernel, 21
    classes, the 600 px scale capped at 1000."""
    from aznet_tpu_torch.config import Config, cfg_from_dict

    return cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "resnet101_c4", "POOL_SIZE": 14, "POOLING_MODE": "align_pallas",
                  "NUM_CLASSES": 21, "STEM_S2D": False},
        "TEST": {"SCALES": (600,), "MAX_SIZE": 1000}})


def phase8b_c4_detect(dev):
    """One bf16 ``make_detect_batch`` call of the C4 detector at the
    benchmark cell's size, every launch count set to 0 just before and read
    just after, every launch held against its plain version. Returns the
    launches, the kernels' errors and img/s."""
    import torch

    from aznet_tpu_torch import api, kernels
    from aznet_tpu_torch.ops.cuda import launch_counts, set_launch_counts

    cfg = c4_config()
    t0 = time.perf_counter()
    net = api.build_frcnn_net(cfg, device=dev)
    torch.cuda.synchronize()
    print(f"phase8b build_frcnn_net (resnet101_c4): {time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in net.model.parameters())} params", flush=True)
    h, w = RAW_HW
    rng = np.random.RandomState(4)
    images = torch.from_numpy(
        rng.randint(0, 256, (C4_BATCH,) + RAW_HW + (3,)).astype(np.uint8)).to(dev)
    xy = rng.uniform(0, (w - 17, h - 17), (C4_BATCH, C4_BOXES, 2))
    far = np.minimum(xy + rng.uniform(16, 300, (C4_BATCH, C4_BOXES, 2)), (w - 1, h - 1))
    boxes = torch.from_numpy(np.concatenate([xy, far], -1).astype(np.float32)).to(dev)
    fn = api.make_detect_batch(net.model, cfg, CANVAS)
    fn(images, boxes)  # builds the kernels
    torch.cuda.synchronize()

    before = launch_counts()
    with kernels.recording() as recorded:
        set_launch_counts()
        scores, pred = fn(images, boxes)
        torch.cuda.synchronize()
        now = launch_counts()
    set_launch_counts({k: before[k] + v for k, v in now.items()})  # main's running counts
    launched = {k: v for k, v in now.items() if v}
    print(f"phase8b main path: launches {launched}", flush=True)
    want = {"frozen_bn": 91 + 9 * C4_BATCH, "roi_align": C4_BATCH}
    check(launched == want, f"phase8b: launches {launched}, not {want}")
    for i in range(C4_BATCH):
        check_detections(f"phase8b image {i}", scores[i], pred[i], RAW_HW, cfg.MODEL.NUM_CLASSES)
    feat_shape = (CANVAS[0] // 16, CANVAS[1] // 16, 1024)
    rois = [r.args for r in recorded if r.name == "roi_align"]
    check(all(tuple(a[0].shape) == feat_shape and a[0].dtype == torch.bfloat16 and a[3] == 14
              and a[1].shape[0] == C4_BOXES for a in rois),
          f"phase8b: ROI align not at pool 14 on the {feat_shape} bf16 map with "
          f"{C4_BOXES} boxes")
    errs = hold("phase8b", recorded)
    check(errs.keys() == want.keys(), f"phase8b: kernels held {sorted(errs)}")
    recorded.clear()

    ms = cuda_ms(lambda: fn(images, boxes), 5, 2)
    torch.cuda.reset_peak_memory_stats()
    fn(images, boxes)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ips = C4_BATCH / (ms / 1e3)
    print(f"phase8b make_detect_batch b={C4_BATCH} R={C4_BOXES}: {ms:.3f} ms/call, "
          f"{ips:.2f} img/s; peak {peak:.2f} GiB", flush=True)
    del net
    torch.cuda.empty_cache()
    return {"launches": launched, "err": errs, "ips": ips}


def fpn_config():
    """The R-101-FPN detector at ``benchmark/configs/resnet101_fpn.json``'s
    settings: bf16 (``Config()``'s), ROI align to 7 over P2-P5 through the
    levels kernel, fc6 and fc7 of 1024, 81 classes, the 800 px scale capped
    at 1333."""
    from aznet_tpu_torch.config import Config, cfg_from_dict

    return cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "resnet101_fpn", "POOL_SIZE": 7, "POOLING_MODE": "align_pallas",
                  "NUM_CLASSES": 81, "FC_DIM": 1024, "FC7_DIM": 0, "STEM_S2D": False},
        "TEST": {"SCALES": (800,), "MAX_SIZE": 1333}})


def levels_bound(args):
    """(bound_ms, bound_by) of one levels launch on its recorded ``args``:
    :func:`roi_bound` on each level's map with the rois the level rule gives
    it, at ``1 / stride``, summed over the levels (as the benchmark's
    ``roi_align_levels_roofline`` sums them); ``bound_by`` each level's."""
    from aznet_tpu_torch.ops import roi_pool as troi

    levels, rois, strides, _, w_first, _ = args
    level = troi.box_levels(rois, strides)
    parts = [roi_bound(feat, rois[level == k], wf, 1.0 / s)
             for k, (feat, s, wf) in enumerate(zip(levels, strides, w_first))
             if bool((level == k).any())]
    return sum(ms for ms, _ in parts), "/".join(by for _, by in parts)


def phase8c_fpn_detect(dev):
    """One bf16 ``make_detect_batch`` call of the R-101-FPN detector at the
    benchmark cell's size (4 images, 1000 boxes each over all four levels),
    every launch count set to 0 just before and read just after, every
    launch held against its plain version; the next two calls, which capture
    and replay the trunk's CUDA graph, against its bits and counts; the
    call's time (replays); then the levels kernel alone on
    the call's first image (events, device and host time, its plain
    version, the einsum ``'align'`` over the levels, the bound summed over
    the levels). Returns the launches, the kernels' errors, img/s and the
    kernel's times."""
    import torch

    from aznet_tpu_torch import api, kernels
    from aznet_tpu_torch.ops import roi_pool as troi
    from aznet_tpu_torch.ops.cuda import launch_counts, set_launch_counts

    cfg = fpn_config()
    t0 = time.perf_counter()
    net = api.build_frcnn_net(cfg, device=dev)
    torch.cuda.synchronize()
    print(f"phase8c build_frcnn_net (resnet101_fpn): {time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in net.model.parameters())} params", flush=True)
    h, w = FPN_RAW_HW
    rng = np.random.RandomState(8)
    images = torch.from_numpy(
        rng.randint(0, 256, (FPN_BATCH,) + FPN_RAW_HW + (3,)).astype(np.uint8)).to(dev)
    side = np.exp(rng.uniform(np.log(16), np.log(h), (FPN_BATCH, FPN_BOXES, 1)))
    aspect = np.exp(rng.uniform(np.log(0.5), np.log(2.0), (FPN_BATCH, FPN_BOXES, 1)))
    wh = np.minimum(side * np.concatenate([np.sqrt(aspect), 1 / np.sqrt(aspect)], -1),
                    (w - 1, h - 1))
    xy = rng.uniform(0, 1, (FPN_BATCH, FPN_BOXES, 2)) * ((w - 1, h - 1) - wh)
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32)).to(dev)
    fn = api.make_detect_batch(net.model, cfg, FPN_CANVAS)
    fn(images, boxes)  # builds the kernels
    torch.cuda.synchronize()

    before = launch_counts()
    with kernels.recording() as recorded:
        set_launch_counts()
        scores, pred = fn(images, boxes)
        torch.cuda.synchronize()
        now = launch_counts()
    set_launch_counts({k: before[k] + v for k, v in now.items()})  # main's running counts
    launched = {k: v for k, v in now.items() if v}
    print(f"phase8c main path: launches {launched}", flush=True)
    want = {"frozen_bn": 100, "roi_align_levels": FPN_BATCH}
    check(launched == want, f"phase8c: launches {launched}, not {want}")
    for i in range(FPN_BATCH):
        check_detections(f"phase8c image {i}", scores[i], pred[i], FPN_RAW_HW,
                         cfg.MODEL.NUM_CLASSES)
    calls = [r.args for r in recorded if r.name == "roi_align_levels"]
    split = [troi.box_levels(a[1], a[2]).bincount(minlength=4).tolist() for a in calls]
    check(all([tuple(f.shape) for f in a[0]] == list(FPN_LEVELS) and a[0][0].dtype ==
              torch.bfloat16 and a[3] == 7 and a[1].shape[0] == FPN_BOXES for a in calls)
          and all(min(n) > 0 for n in split),
          f"phase8c: the levels kernel not at pool 7 on the {FPN_LEVELS} bf16 maps with "
          f"{FPN_BOXES} boxes on every level (boxes a level {split})")
    errs = hold("phase8c", recorded)
    check(errs.keys() == want.keys(), f"phase8c: kernels held {sorted(errs)}")
    args = calls[0]
    recorded.clear()
    # Outside a recording the trunk's next call captures its CUDA graph and the
    # one after replays it: each gives the held call's bits and counts its launches.
    running = launch_counts()
    for tag in ("capture", "replay"):
        set_launch_counts()
        got = fn(images, boxes)
        torch.cuda.synchronize()
        n = {k: v for k, v in launch_counts().items() if v}
        same = [torch.equal(a, b) for a, b in zip(got, (scores, pred))]
        print(f"phase8c trunk graph {tag}: launches {n}, bits of the held call {same}", flush=True)
        check(n == want and all(same), f"phase8c trunk graph {tag}: launches {n}, same {same}")
        running = {k: running[k] + n.get(k, 0) for k in running}
    set_launch_counts(running)

    ms = cuda_ms(lambda: fn(images, boxes), 5, 2)
    torch.cuda.reset_peak_memory_stats()
    fn(images, boxes)
    peak = torch.cuda.max_memory_allocated()
    ips = FPN_BATCH / (ms / 1e3)
    print(f"phase8c make_detect_batch b={FPN_BATCH} R={FPN_BOXES}: {ms:.3f} ms/call, "
          f"{ips:.2f} img/s; peak {peak} bytes", flush=True)
    del net
    torch.cuda.empty_cache()

    levels, rois, strides = args[:3]
    run = lambda: troi.roi_align_levels(levels, rois, strides, 7)
    k = {"ms": cuda_ms(run, 50, 3), "device_us": device_us(run, "roi_align_levels_kernel"),
         "host_us": host_us(run),
         "plain_ms": cuda_ms(lambda: troi.roi_align_levels_reference(*args), 5, 1),
         "library_ms": cuda_ms(lambda: troi.roi_pool_levels(levels, rois, strides, 7,
                                                             mode="align"), 5, 1),
         "bound": levels_bound(args), "boxes_a_level": split[0]}
    print(f"phase8c roi_align_levels alone ({' / '.join(map(str, split[0]))} boxes on P2-P5): "
          f"{roi_times_line(k)}; plain {k['plain_ms']:.4f} ms, library (einsum 'align' a "
          f"level) {k['library_ms']:.4f} ms, bound {k['bound'][0] * 1e3:.3f} us "
          f"({k['bound'][1]})", flush=True)
    return {"launches": launched, "err": errs, "ips": ips, "kernel": k}


def phase9_small(dev):
    """CaffeNet and VGG_CNN_M_1024 from their config files, bf16,
    ``POOLING_MODE='align_pallas'`` (the ROI-align kernel at P=6), on two raw
    375x500 images on a 608x800 canvas; then each on the card against the
    CPU at a small image."""
    import torch

    out = {}
    for backbone, name in (("caffenet", "az_caffenet_voc"),
                           ("vgg_cnn_m_1024", "az_vgg_cnn_m_1024_voc")):
        cfg = cfg_file(name, POOLING_MODE="align_pallas")
        check(cfg.MODEL.BACKBONE == backbone and cfg.MODEL.POOL_SIZE == 6, f"{name}: config")
        net = build_net(f"phase9 {backbone}", cfg, dev)
        out[backbone] = propose_phase(dev, f"phase9 {backbone}", net, RAW_HW, CANVAS)
        check(any(m[2] == 6 for m in out[backbone]["modes"]), f"{backbone}: no P=6 launch")
        del net
        torch.cuda.empty_cache()
        card_vs_cpu(f"phase9 {backbone}", cfg_file(name), dev)
    return out


EVAL_IMDB = "synthetic_hard_test"  # VOC-sized (375x500) planted boxes, 4 classes
EVAL_IMAGES, EVAL_BATCH, EVAL_SEQ, EVAL_CALIB = 16, 8, 4, 8
EVAL_CANVAS = (640, 832)  # 375x500 at scale 1.6 is 600x800, rounded up to 64 (api._canvas_for)
# tests/test_torch_eval.py's bounds. Float32: scores, boxes (px). Fused
# against two-program detect in bf16: scores, boxes (px), the share of rows
# of either side with no counterpart (bf16 rounds the two programs' rois
# apart, which can move a detection across the per-image cap or an NMS
# decision).
S_TOL, B_TOL = 1e-5, 2e-3
FUSED_S_TOL, FUSED_B_TOL, FUSED_MISS = 1e-2, 1.0, 0.05


def eval_config():
    """:func:`detect_config` with the synthetic imdb's 4 classes."""
    import dataclasses

    cfg = detect_config()
    return dataclasses.replace(cfg, MODEL=dataclasses.replace(cfg.MODEL, NUM_CLASSES=4))


@contextlib.contextmanager
def first_batch(builder, recorders):
    """While active, the function that ``api.<builder>`` builds runs its first
    call (one batch of a driver) inside the context managers ``recorders``."""
    from aznet_tpu_torch import api

    real, done = getattr(api, builder), []

    def build(*args, **kwargs):
        fn = real(*args, **kwargs)

        def call(*a):
            if done:
                return fn(*a)
            done.append(True)
            with contextlib.ExitStack() as stack:
                for rec in recorders:
                    stack.enter_context(rec)
                return fn(*a)
        return call

    setattr(api, builder, build)
    try:
        yield
    finally:
        setattr(api, builder, real)
    check(done, f"{builder}: no batch ran")


@contextlib.contextmanager
def wrapped(module, name, before=None, after=None):
    """Wraps ``module.<name>``: ``before(*args)`` then the call, then
    ``after(result, seconds)``."""
    real = getattr(module, name)

    def call(*args, **kwargs):
        if before:
            before(*args)
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        if after:
            after(out, time.perf_counter() - t0)
        return out

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, real)


def check_proposals(tag, props, imdb, n_max):
    for i, p in enumerate(props):
        e = imdb.roidb[i]
        check(p.ndim == 2 and p.shape[1] == 5 and 1 <= p.shape[0] <= n_max
              and np.isfinite(p).all(), f"{tag} image {i}: proposals {p.shape}")
        check(bool((p[:, :4] >= 0).all() and (p[:, 0:4:2] <= e["width"]).all()
                   and (p[:, 1:4:2] <= e["height"]).all()),
              f"{tag} image {i}: proposals outside the {e['height']}x{e['width']} image")


def check_all_boxes(tag, all_boxes, n_cls, n_img):
    check(len(all_boxes) == n_cls and all(len(a) == n_img for a in all_boxes),
          f"{tag}: all_boxes is not {n_cls} x {n_img}")
    for c in range(n_cls):
        for d in all_boxes[c]:
            check(d.ndim == 2 and d.shape[1] == 5 and np.isfinite(d).all(),
                  f"{tag}: class {c} holds {d.shape}")
    total = sum(len(d) for a in all_boxes[1:] for d in a)
    check(total > 0, f"{tag}: no detections")
    return total


def matched(a, b, s_tol, b_tol):
    """Rows of ``a [N, 5]`` with a row of ``b`` within ``b_tol`` px and
    ``s_tol`` in score."""
    if not len(a):
        return np.zeros(0, bool)
    if not len(b):
        return np.zeros(len(a), bool)
    return ((np.abs(a[:, None, :4] - b[None, :, :4]).max(-1) <= b_tol)
            & (np.abs(a[:, None, 4] - b[None, :, 4]) <= s_tol)).any(1)


def dets_agreement(a, b, s_tol, b_tol):
    """(images whose per-class counts differ, share of rows of either side
    with no counterpart in the other, same class, within the tolerances)."""
    differ, miss, total = 0, 0, 0
    for c in range(1, len(a)):
        for x, y in zip(a[c], b[c]):
            differ += len(x) != len(y)
            miss += int((~matched(x, y, s_tol, b_tol)).sum() + (~matched(y, x, s_tol, b_tol)).sum())
            total += len(x) + len(y)
    return differ, miss / max(total, 1)


def check_recall(tag, table):
    vals = [v for row in table.values() for v in row.values()]
    check(all(0.0 <= v <= 1.0 for v in vals), f"{tag}: recall outside [0, 1]: {table}")
    return " ".join(f"@{k}: " + ", ".join(f"{t}={v:.4f}" for t, v in row.items())
                    for k, row in table.items())


def phase10_eval(dev, card):
    """The dataset drivers on the first 16 images of ``synthetic_hard_test``
    (375x500 on a 640x832 canvas, batch 8) with VGG-16 bf16 at full width,
    ``'align_pallas'`` + ``FUSE_CONV1``, the AZ and Fast R-CNN nets joined by
    ``share_trunk``: evaluate_recall (batched, then refined), evaluate_recall
    per image on 4, detect_all_batched fused and two-program, detect_all on
    4, evaluate_detections, calibrate_net_on_imdb on 8, then evaluate_recall
    with the int8 net. Every launch count is set to 0 just before and read
    just after; the first batch's kernel inputs are recorded and held against
    the plain versions. Returns the launches and errors."""
    import torch

    from aznet_tpu_torch import api, kernels
    from aznet_tpu_torch.data import SyntheticImdb, get_imdb
    from aznet_tpu_torch.eval import detection as tdet
    from aznet_tpu_torch.ops.cuda import launch_counts, set_launch_counts
    from aznet_tpu_torch.ops.quant import calibrate_net_on_imdb
    from aznet_tpu_torch.utils import native

    t0 = time.perf_counter()
    lib = native.build()
    print(f"phase10 host library {lib.relative_to(native.BUILD_ROOT.parent.parent)} built in "
          f"{time.perf_counter() - t0:.2f} s ({native.CXX} {' '.join(native.CXX_FLAGS)})",
          flush=True)
    cfg = eval_config()
    az = api.build_az_net(cfg, device=dev)
    fr = api.share_trunk(api.build_frcnn_net(cfg, device=dev, seed=cfg.RNG_SEED + 1), az)
    # The first 16 images of the registered imdb (each image is made from its
    # own seed), as an imdb of their own, so that evaluate_detections covers
    # exactly the images detected.
    t0 = time.perf_counter()
    full = get_imdb(EVAL_IMDB)
    imdb = SyntheticImdb(split="test", seed=full.seed, num_images=EVAL_IMAGES,
                         image_hw=full.image_hw, hard=full.hard)
    roidb = imdb.roidb
    n_gt = sum(int((~e["difficult"]).sum()) for e in roidb)
    print(f"phase10 the first {EVAL_IMAGES} images of {EVAL_IMDB} made in "
          f"{time.perf_counter() - t0:.2f} s: {n_gt} gt boxes (not difficult)", flush=True)
    check(all((e["height"], e["width"]) == RAW_HW for e in roidb)
          and api._canvas_for(*RAW_HW, cfg) == EVAL_CANVAS, "the eval images' canvas")
    n_cls, n_props = cfg.MODEL.NUM_CLASSES, cfg.SEAR.NUM_PROPOSALS
    # Warm-up outside the measured path (cuDNN's first calls at these shapes).
    tdet.propose_all_batched(az, imdb, batch_size=EVAL_BATCH, max_images=EVAL_BATCH)
    torch.cuda.synchronize()

    host_nms = {"calls": 0, "s": 0.0}
    props, fused_calls, times = {}, [], {}
    recorded = []

    def run(name, n, fn):
        before = launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        times[name] = (s, n)
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        print(f"phase10 {name}: {s * 1e3:.1f} ms for {n} images, {s * 1e3 / n:.2f} ms/image, "
              f"{n / s:.2f} img/s ({card}); launches {delta}", flush=True)
        return out

    def keep(name):
        return lambda out, _s: props.setdefault(name, out)

    def count_nms(out, s):
        host_nms["calls"] += 1
        host_nms["s"] += s

    set_launch_counts()
    with wrapped(tdet, "nms", after=count_nms):
        with first_batch("make_propose_batch_padded", [kernels.recording(records=recorded)]), \
                wrapped(tdet, "propose_all_batched", after=keep("bf16")):
            rec_bf16 = run("evaluate_recall batched", EVAL_IMAGES, lambda: tdet.evaluate_recall(
                az, imdb, max_images=EVAL_IMAGES, batched=True, batch_size=EVAL_BATCH))
        rec_ref = run("evaluate_recall batched + refine", EVAL_IMAGES,
                      lambda: tdet.evaluate_recall(az, imdb, max_images=EVAL_IMAGES, batched=True,
                                                   batch_size=EVAL_BATCH, refine_net=fr))
        with wrapped(tdet, "propose_all", after=keep("seq")):
            rec_seq = run("evaluate_recall per image", EVAL_SEQ, lambda: tdet.evaluate_recall(
                az, imdb, max_images=EVAL_SEQ, batched=False))
        with first_batch("make_fused_detect_batch_padded",
                         [kernels.recording(records=recorded)]), \
                wrapped(tdet, "detect_all_fused", before=lambda *a: fused_calls.append(1)):
            nms0 = dict(host_nms)
            dets = run("detect_all_batched fused=None", EVAL_IMAGES, lambda: tdet.detect_all_batched(
                az, fr, imdb, batch_size=EVAL_BATCH, max_images=EVAL_IMAGES))
            nms_fused = (host_nms["calls"] - nms0["calls"], host_nms["s"] - nms0["s"])
        check(fused_calls == [1], "detect_all_batched(fused=None) did not take the fused program")
        dets_two = run("detect_all_batched fused=False", EVAL_IMAGES,
                       lambda: tdet.detect_all_batched(az, fr, imdb, batch_size=EVAL_BATCH,
                                                       max_images=EVAL_IMAGES, fused=False))
        dets_seq = run("detect_all", EVAL_SEQ,
                       lambda: tdet.detect_all(az, fr, imdb, max_images=EVAL_SEQ))
    t0 = time.perf_counter()
    aps = imdb.evaluate_detections(dets, "")
    print(f"phase10 evaluate_detections: {(time.perf_counter() - t0) * 1e3:.1f} ms; "
          + ", ".join(f"{k} {v:.4f}" for k, v in aps.items()), flush=True)
    bf16_counts = launch_counts()
    check(bf16_counts["chain"] == bf16_counts["strip"] == 0, f"int8 conv ran in bf16: {bf16_counts}")
    net8 = run("calibrate_net_on_imdb", EVAL_CALIB,
               lambda: calibrate_net_on_imdb(az, imdb, n_images=EVAL_CALIB))
    print(f"phase10 int8 scales: trunk {[round(s, 6) for s in net8.cfg.MODEL.INT8_SCALES]}, "
          f"head {[round(s, 6) for s in net8.cfg.MODEL.INT8_HEAD_SCALES]}", flush=True)
    with first_batch("make_propose_batch_padded", [kernels.recording(records=recorded)]), \
            wrapped(tdet, "propose_all_batched", after=keep("int8")):
        rec_int8 = run("evaluate_recall batched int8", EVAL_IMAGES, lambda: tdet.evaluate_recall(
            net8, imdb, max_images=EVAL_IMAGES, batched=True, batch_size=EVAL_BATCH))
    launches = launch_counts()
    print(f"phase10 main path: launches {launches}", flush=True)
    check(all(v > 0 for k, v in launches.items()
              if k not in ("iou", "conv1_f32", "frozen_bn", "roi_align_levels")),
          f"a kernel never ran on the eval path: {launches}")
    # Recall takes its IoU from the host (eval/recall.py): no driver calls the IoU kernel.
    # The nets are VGG-16, which has no frozen BatchNorm.
    check(launches["iou"] == 0 and launches["frozen_bn"] == 0,
          f"the IoU or frozen BatchNorm kernel ran on the eval path: {launches}")
    print(f"phase10 host NMS (per class, host library): {host_nms['calls']} calls, "
          f"{host_nms['s'] * 1e3 / host_nms['calls']:.4f} ms per call; fused detect "
          f"{nms_fused[1] * 1e3 / EVAL_IMAGES:.3f} ms per image ({nms_fused[0]} calls)", flush=True)

    for tag, table in (("bf16", rec_bf16), ("refined", rec_ref), ("per image", rec_seq),
                       ("int8", rec_int8)):
        print(f"phase10 recall {tag}: {check_recall(tag, table)}", flush=True)
    for tag, p, n in (("bf16", props["bf16"], EVAL_IMAGES), ("per image", props["seq"], EVAL_SEQ),
                      ("int8", props["int8"], EVAL_IMAGES)):
        check(len(p) == n, f"{tag}: {len(p)} proposal lists")
        check_proposals(f"phase10 {tag}", p, imdb, n_props)
    for tag, a, n in (("fused", dets, EVAL_IMAGES), ("two-program", dets_two, EVAL_IMAGES),
                      ("detect_all", dets_seq, EVAL_SEQ)):
        print(f"phase10 {tag}: {check_all_boxes(tag, a, n_cls, n)} detections", flush=True)
    check(all(0.0 <= v <= 1.0 for v in aps.values()), f"AP outside [0, 1]: {aps}")
    differ, miss = dets_agreement(dets, dets_two, FUSED_S_TOL, FUSED_B_TOL)
    print(f"phase10 fused vs two-program: {differ} (class, image) counts differ, {miss:.4f} of "
          f"rows unmatched within {FUSED_S_TOL} / {FUSED_B_TOL} px", flush=True)
    check(miss <= FUSED_MISS, "fused and two-program detect_all_batched disagree")

    errs = hold("phase10", recorded, "the first batches' inputs")
    check(errs.keys() >= {"nms", "roi_align", "conv1", "chain", "strip", "search_seed",
                          "search_level", "search_select"},
          f"a kernel was not recorded on the first batches: {sorted(errs)}")
    del az, fr, net8, recorded
    torch.cuda.empty_cache()
    return {"launches": launches, "err": errs, "times": times}


def phase10_reference(dev):
    """The drivers on the card against the port on the CPU: VGG-16 at WIDTH
    0.125, float32, ``'align_pallas'``, 4 classes, a small search, the nets
    joined by ``share_trunk``, on 4 images of the eval imdb at batch 2, with
    the CPU test's tolerances (tests/test_torch_eval.py): proposals per image
    the same count, sorted scores to 1e-5, each box within 2e-3 px of a box
    of the other side; detections the same count per class and image, each
    row within those bounds of a row of the other side; recall within one
    gt match."""
    from aznet_tpu_torch import api
    from aznet_tpu_torch.config import cfg_from_dict
    from aznet_tpu_torch.data import get_imdb
    from aznet_tpu_torch.eval import detection as tdet
    from aznet_tpu_torch.ops.cuda import launch_counts

    cfg = cfg_from_dict(eval_config(), {
        "MODEL": {"WIDTH": 0.125, "FC_DIM": 64, "COMPUTE_DTYPE": "float32", "FUSE_CONV1": False},
        "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 2, "NUM_PROPOSALS": 10},
        "TEST": {"SCALES": (64,), "MAX_SIZE": 128}})
    imdb = get_imdb(EVAL_IMDB)
    nets = {}
    for d in ("cpu", dev):
        seed = {} if d == "cpu" else {"state_dict": nets["cpu"][0].params}
        az = api.build_az_net(cfg, device=d, **seed)
        fr_seed = ({"seed": cfg.RNG_SEED + 1} if d == "cpu"
                   else {"state_dict": nets["cpu"][1].params})
        nets[d] = (az, api.share_trunk(api.build_frcnn_net(cfg, device=d, **fr_seed), az))
    out = {}
    before = launch_counts()
    for d, (az, fr) in nets.items():
        out[d] = {
            "props": tdet.propose_all_batched(az, imdb, batch_size=2, max_images=EVAL_SEQ),
            "fused": tdet.detect_all_batched(az, fr, imdb, batch_size=2, max_images=EVAL_SEQ),
            "two": tdet.detect_all_batched(az, fr, imdb, batch_size=2, max_images=EVAL_SEQ,
                                           fused=False),
            "seq": tdet.detect_all(az, fr, imdb, max_images=EVAL_SEQ),
            "recall": tdet.evaluate_recall(az, imdb, top_ks=(5, 10), max_images=EVAL_SEQ,
                                           batched=True, batch_size=2)}
    after = launch_counts()
    launched = tuple(after[k] - before[k] for k in ("nms", "roi_align"))
    got, want = out[dev], out["cpu"]
    check(all(launched), f"the small config did not run the kernels: {launched}")
    d_s, near = 0.0, 1.0
    for g, w in zip(got["props"], want["props"]):
        check(g.shape == w.shape and len(g) > 0, f"proposals {g.shape} vs {w.shape}")
        d_s = max(d_s, float(np.abs(np.sort(g[:, 4]) - np.sort(w[:, 4])).max()))
        near = min(near, float(matched(g, w, np.inf, B_TOL).mean()),
                   float(matched(w, g, np.inf, B_TOL).mean()))
    line = (f"phase10 reference (VGG-16 WIDTH 0.125 f32, card vs CPU, launches (nms, roi_align) "
            f"{launched}): proposals max |d score| {d_s:.3g}, {near:.3f} of boxes matched")
    check(d_s <= S_TOL and near == 1.0, "card and CPU proposals disagree")
    for key in ("fused", "two", "seq"):
        differ, miss = dets_agreement(got[key], want[key], S_TOL, B_TOL)
        line += f"; {key}: {differ} counts differ, {miss:.4f} unmatched"
        check(differ == 0 and miss == 0.0, f"card and CPU detections ({key}) disagree")
    n_gt = sum(int((~e["difficult"]).sum()) for e in imdb.roidb[:EVAL_SEQ])
    d_r = max(abs(got["recall"][k][t] - want["recall"][k][t])
              for k in want["recall"] for t in want["recall"][k])
    print(line + f"; recall max diff {d_r:.4f} (bound 1/{n_gt})", flush=True)
    check(d_r <= 1.0 / n_gt, "card and CPU recall differ by more than one gt match")


TRAIN_IMDB = "synthetic_hard_train"  # VOC-sized 375x500 planted boxes, 512 images, 4 classes
TRAIN_STEPS, TRAIN_WARMUP, RESUME_STEPS = 12, 2, 14
MINE_INTERVAL, MINE_IMAGES = 4, 8
CHAIN_IMAGES, FRCNN_STEPS, WORKER_STEPS = 8, 6, 10
PROFILED = ((5, 7), (9, 11))  # step windows between the harvests at steps 4 and 8
# tests/test_torch_train.py's bounds. Float32: loss and metrics relative,
# each parameter's update against its largest update. bf16: loss relative.
F32_TOL, F32_UPDATE_TOL, BF16_TOL = 1e-4, 2e-3, 1e-2


def train_config(**train):
    """``Config()`` (VGG-16 bf16 at full width, ``'align'``, no
    ``FUSE_CONV1``, TRAIN.SCALES 600, IMS_PER_BATCH 2, REGIONS_PER_IMAGE 128,
    DROPOUT 0.5) with the synthetic imdb's 4 classes and ``train``."""
    from aznet_tpu_torch.config import Config, cfg_from_dict

    return cfg_from_dict(Config(), {"MODEL": {"NUM_CLASSES": 4}, "TRAIN": train})


def imdb_over(base, roidb):
    """A new imdb object over ``roidb`` (a train loop appends the flipped
    entries to the imdb it is given)."""
    import copy

    out = copy.copy(base)
    out._roidb = list(roidb)
    return out


class TrainProbe:
    """While active, every train step that ``train/loop.py`` builds is timed
    by CUDA events and its metrics kept; the loop's waits on either
    prefetcher are timed; each harvest is timed (synchronised), its NMS
    launches counted, and the first one's kernel launches recorded; the steps of
    each ``windows`` pair (first, last) run under ``torch.profiler`` for the
    card's busy share."""

    def __init__(self, windows=()):
        self.windows = windows
        self.steps, self.waits, self.harvests, self.records = [], [], [], []
        self.profiles, self.window_s = [], 0.0  # profilers of the windows, their wall s
        self.first_batches, self.builds = [], []  # the loop's own batch builds, s
        self.worker_env = {}
        # Gaps between step i and i + 1 that hold a harvest or a profiler's
        # start or stop: left out of the loop's rate.
        self.dirty = set()

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from aznet_tpu_torch import kernels
        from aznet_tpu_torch.data import prefetch
        from aznet_tpu_torch.ops.cuda import launch_counts
        from aznet_tpu_torch.train import loop, mining

        probe, self._stack = self, contextlib.ExitStack()

        def timed_step(make):
            def build(*args, **kwargs):
                step = make(*args, **kwargs)

                def call(state, batch, seed):
                    i = len(probe.steps)
                    if any(i == a for a, _ in probe.windows):
                        torch.cuda.synchronize()
                        probe.dirty.add(i - 1)
                        probe.profiles.append(profile(activities=[ProfilerActivity.CUDA]))
                        probe.profiles[-1].__enter__()
                        probe._t0 = time.perf_counter()
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    t0 = time.perf_counter()
                    start.record()
                    metrics = step(state, batch, seed)
                    end.record()
                    probe.steps.append((start, end, t0, metrics))
                    if any(i == b for _, b in probe.windows):
                        torch.cuda.synchronize()
                        probe.window_s += time.perf_counter() - probe._t0
                        probe.profiles[-1].__exit__(None, None, None)
                        probe.dirty.add(i)
                    return metrics
                return call
            return build

        def timed_next(cls):
            real = cls.next

            def call(pf):
                t0 = time.perf_counter()
                batch = real(pf)
                probe.waits.append(time.perf_counter() - t0)
                if cls is prefetch.MPPrefetcher:
                    probe.worker_env = pf.worker_env
                    if len(probe.first_batches) < 2:
                        probe.first_batches.append(batch)
                return batch
            return real, call

        real_harvest = mining.RegionMiner.harvest

        def harvest(miner, model):
            probe.dirty.add(len(probe.steps) - 1)
            torch.cuda.synchronize()
            n0, t0 = launch_counts()["nms"], time.perf_counter()
            with contextlib.ExitStack() as stack:
                if not probe.harvests:
                    stack.enter_context(kernels.recording(records=probe.records))
                n = real_harvest(miner, model)
            torch.cuda.synchronize()
            probe.harvests.append((time.perf_counter() - t0, n, launch_counts()["nms"] - n0))
            return n

        for name in ("make_az_train_step", "make_frcnn_train_step"):
            self._stack.enter_context(wrapped_attr(loop, name, timed_step(getattr(loop, name))))
        for cls in (loop._Prefetcher, prefetch.MPPrefetcher):
            self._stack.enter_context(wrapped_attr(cls, "next", timed_next(cls)[1]))
        self._stack.enter_context(wrapped_attr(mining.RegionMiner, "harvest", harvest))
        real_build = loop.get_az_minibatch

        def build(*args, **kwargs):
            t0 = time.perf_counter()
            out = real_build(*args, **kwargs)
            probe.builds.append(time.perf_counter() - t0)
            return out

        self._stack.enter_context(wrapped_attr(loop, "get_az_minibatch", build))
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._stack.close()

    def metrics(self):
        return [{k: float(v) for k, v in m.items()} for *_, m in self.steps]

    def busy(self):
        """(kernel ms, wall ms, share) over the profiled windows."""
        kernel_ms = sum(kernel_us(p.key_averages()) for p in self.profiles) / 1e3
        return kernel_ms, self.window_s * 1e3, kernel_ms / (self.window_s * 1e3)

    def summary(self, ims, warmup):
        """After ``warmup`` steps: (ms per step by events, img/s at that rate,
        img/s of the loop: ``ims`` over the mean time from one step's start to
        the next's by the same events, gaps that hold a harvest or a profiler
        start or stop left out, mean prefetch wait ms per step)."""
        steady = self.steps[warmup:]
        ms = sum(s.elapsed_time(e) for s, e, *_ in steady) / len(steady)
        gaps = [self.steps[i][0].elapsed_time(self.steps[i + 1][0])
                for i in range(warmup, len(self.steps) - 1) if i not in self.dirty]
        wait = sum(self.waits[warmup:]) / len(self.waits[warmup:]) * 1e3
        return ms, ims * 1e3 / ms, ims * 1e3 * len(gaps) / sum(gaps), wait


def kernel_us(events):
    """Microseconds of the card's own events (kernels, copies) in a profile:
    a host operator's device time counts its kernels again."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA)


@contextlib.contextmanager
def wrapped_attr(owner, name, value):
    real = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, real)


def check_metrics(tag, metrics, keys):
    for i, m in enumerate(metrics):
        check(set(keys) <= set(m) and all(np.isfinite(m[k]) for k in keys),
              f"{tag} step {i + 1}: metrics {m}")


def phase11_train(dev, card):
    """Training at full VGG-16 width on ``synthetic_hard_train``: (a) AZ-Net,
    12 steps with mining every 4 steps over 8 images, timed; (b) a resume to
    14; (c) the chain: an inference net from the ``deploy/`` weights with the
    detect configuration, ``propose_all`` over 8 training images, Fast R-CNN
    trained 6 steps on those proposals; (d) ``REMAT_TRUNK`` on against off,
    and 4 prefetch workers against the thread; (e) one AZ and one Fast R-CNN
    step on the card against the CPU (smallnet, float32). Every launch count
    is set to 0 at the start and read at the end. Returns the launches and
    the NMS error on the first harvest's inputs."""
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from aznet_tpu_torch import api
    from aznet_tpu_torch.data import get_imdb
    from aznet_tpu_torch.data.minibatch import fixed_canvas, get_az_minibatch
    from aznet_tpu_torch.data.prefetch import MPPrefetcher, az_batch_builder
    from aznet_tpu_torch.data.synthetic import SyntheticImdb
    from aznet_tpu_torch.eval.detection import propose_all
    from aznet_tpu_torch.ops.cuda import launch_counts, set_launch_counts
    from aznet_tpu_torch.train import loop
    from aznet_tpu_torch.train.train_az import make_az_train_state, make_az_train_step
    from aznet_tpu_torch.utils.checkpoint import Checkpointer

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    base = get_imdb(TRAIN_IMDB)
    roidb = list(base.roidb)
    print(f"phase11 {TRAIN_IMDB}: {len(roidb)} images made in {time.perf_counter() - t0:.2f} s",
          flush=True)
    out_root = tempfile.mkdtemp(prefix="aznet_train_")
    set_launch_counts()
    try:
        # (a) AZ-Net with mining.
        cfg = train_config(MINE_INTERVAL=MINE_INTERVAL, MINE_IMAGES=MINE_IMAGES)
        check(fixed_canvas(imdb_over(base, roidb), cfg) == CANVAS, "the training canvas")
        state = make_az_train_state(cfg, device=dev)
        watch = {k: v.detach().clone() for k, v in state.model.state_dict().items()
                 if k in ("trunk.conv1_1.weight", "trunk.conv5_3.weight", "head.fc.fc6.weight",
                          "head.adj_bbox.weight")}
        with profile(activities=[ProfilerActivity.CUDA]):  # CUPTI starts here, not in a window
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with TrainProbe(PROFILED) as probe:
            state, model, out = loop.train_az_net(cfg, TRAIN_IMDB, max_iters=TRAIN_STEPS,
                                                  output_dir=f"{out_root}/az", state=state,
                                                  imdb=imdb_over(base, roidb), device=dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        metrics = probe.metrics()
        check(len(metrics) == TRAIN_STEPS and state.step == TRAIN_STEPS, "11a: step count")
        check_metrics("11a", metrics, ("loss", "zoom_loss", "adj_loss", "bbox_loss", "grad_norm"))
        moved = {k: float((state.model.state_dict()[k] - v).abs().max()) for k, v in watch.items()}
        check(all(v > 0 for v in moved.values()), f"11a: parameters did not move: {moved}")
        ms, ips_dev, ips, wait = probe.summary(cfg.TRAIN.IMS_PER_BATCH, TRAIN_WARMUP)
        kernel_ms, window_ms, busy = probe.busy()
        warm = probe.harvests[1:]  # the first harvest also pays the inference shapes' first calls
        harvest_ms = sum(h[0] for h in warm) * 1e3 / sum(h[1] for h in warm)
        harvest_nms = sum(h[2] for h in probe.harvests)
        print(f"phase11a AZ-Net VGG-16 bf16 full width, {TRAIN_STEPS} steps at b=2 on "
              f"{CANVAS[0]}x{CANVAS[1]}, mining every {MINE_INTERVAL} over {MINE_IMAGES} images "
              f"({card}): {wall:.2f} s in train_az_net; after {TRAIN_WARMUP} warm-up steps "
              f"{ms:.3f} ms/step by events ({ips_dev:.2f} img/s), {ips:.2f} img/s from step "
              f"start to step start less the harvests, prefetch wait {wait:.3f} ms/step "
              f"(batch build {np.mean(probe.builds) * 1e3:.1f} ms on the thread); device busy "
              f"{busy:.4f} of steps {list(PROFILED)} (torch.profiler, {kernel_ms:.1f} ms of "
              f"kernels in {window_ms:.1f} ms); peak {peak:.2f} GiB", flush=True)
        print(f"phase11a losses: " + ", ".join(f"{m['loss']:.4f}" for m in metrics)
              + "; grad_norm: " + ", ".join(f"{m['grad_norm']:.3f}" for m in metrics)
              + f"; max |update| {moved}", flush=True)
        print(f"phase11a harvests: {len(probe.harvests)} x {MINE_IMAGES} images, "
              f"{harvest_ms:.2f} ms/image after the first, NMS launches {harvest_nms} "
              f"({[round(h[0] * 1e3, 1) for h in probe.harvests]} ms each)", flush=True)
        check(harvest_nms > 0, "11a: the harvests launched no NMS kernel")
        errs = hold("phase11a", probe.records, "the first harvest's inputs")
        check(errs.keys() >= {"nms", "search_level"},
              f"11a: the first harvest ran no NMS kernel or no search level: {sorted(errs)}")
        ckpt = Checkpointer(out)
        check(ckpt.all_steps() == [TRAIN_STEPS], f"11a: snapshots {ckpt.all_steps()}")
        deploy = Checkpointer(f"{out}/deploy")
        check(deploy.all_steps() == [TRAIN_STEPS], f"11a: deploy snapshots {deploy.all_steps()}")
        del state, model
        torch.cuda.empty_cache()

        # (b) resume.
        with TrainProbe() as probe:
            state, _, _ = loop.train_az_net(cfg, TRAIN_IMDB, max_iters=RESUME_STEPS,
                                            output_dir=out, imdb=imdb_over(base, roidb),
                                            device=dev)
        metrics = probe.metrics()
        check(len(metrics) == RESUME_STEPS - TRAIN_STEPS and state.step == RESUME_STEPS
              and ckpt.all_steps() == [TRAIN_STEPS, RESUME_STEPS],
              f"11b: {len(metrics)} steps to {state.step}, snapshots {ckpt.all_steps()}")
        check_metrics("11b", metrics, ("loss", "grad_norm"))
        print(f"phase11b resumed at step {TRAIN_STEPS}, ran to {state.step}: losses "
              + ", ".join(f"{m['loss']:.4f}" for m in metrics), flush=True)
        del state
        torch.cuda.empty_cache()

        # (c) the chain: deploy weights -> proposals -> Fast R-CNN.
        params, _ = deploy.restore({"params": 0})
        az = api.build_az_net(eval_config(), state_dict=params["params"], device=dev)
        chain_imdb = SyntheticImdb(split="train", seed=base.seed, num_images=CHAIN_IMAGES,
                                   image_hw=base.image_hw, hard=base.hard)
        before = launch_counts()
        t0 = time.perf_counter()
        props = propose_all(az, chain_imdb)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        check_proposals("11c", props, chain_imdb, az.cfg.SEAR.NUM_PROPOSALS)
        check(all(delta[k] > 0 for k in ("nms", "roi_align", "conv1")),
              f"11c: propose_all did not launch every kernel: {delta}")
        print(f"phase11c propose_all with the deploy weights ('align_pallas', FUSE_CONV1) over "
              f"{CHAIN_IMAGES} images: {s * 1e3 / CHAIN_IMAGES:.2f} ms/image, "
              f"{sum(len(p) for p in props)} proposals, launches {delta}", flush=True)
        del az
        cfg_fr = train_config()
        with TrainProbe() as probe:
            state, _, out_fr = loop.train_frcnn_net(
                cfg_fr, TRAIN_IMDB, lambda i: props[i % CHAIN_IMAGES], max_iters=FRCNN_STEPS,
                output_dir=f"{out_root}/frcnn", imdb=chain_imdb, device=dev)
        metrics = probe.metrics()
        check(len(metrics) == FRCNN_STEPS, "11c: Fast R-CNN step count")
        check_metrics("11c", metrics, ("loss", "cls_loss", "bbox_loss", "acc", "grad_norm"))
        check(Checkpointer(f"{out_fr}/deploy").all_steps() == [FRCNN_STEPS], "11c: deploy")
        ms, ips_dev, _, wait = probe.summary(cfg_fr.TRAIN.IMS_PER_BATCH, TRAIN_WARMUP)
        print(f"phase11c Fast R-CNN {FRCNN_STEPS} steps on the proposals: losses "
              + ", ".join(f"{m['loss']:.4f}" for m in metrics) + "; acc "
              + ", ".join(f"{m['acc']:.4f}" for m in metrics)
              + f"; {ms:.3f} ms/step by events, prefetch wait {wait:.3f} ms/step", flush=True)
        del state
        torch.cuda.empty_cache()

        # (d) REMAT_TRUNK, and the prefetch workers.
        cfg0 = train_config()
        imdb = imdb_over(base, roidb[:2])
        batch = get_az_minibatch(imdb, imdb.roidb, cfg0, np.random.RandomState(0),
                                 fixed_canvas(imdb, cfg0))
        out_remat = {}
        for remat in (False, True):
            st = make_az_train_state(cfg0, device=dev)
            step = make_az_train_step(st.model, remat_trunk=remat)
            step(st, batch, cfg0.RNG_SEED + 1)  # warm-up, then the measured first step
            st = make_az_train_state(cfg0, device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            loss = float(make_az_train_step(st.model, remat_trunk=remat)(
                st, batch, cfg0.RNG_SEED)["loss"])
            out_remat[remat] = (loss, torch.cuda.max_memory_allocated() / 2 ** 30)
            del st, step
            torch.cuda.empty_cache()
        (l_off, p_off), (l_on, p_on) = out_remat[False], out_remat[True]
        print(f"phase11d REMAT_TRUNK: first-step loss {l_on:.6f} on, {l_off:.6f} off (same "
              f"dropout generator); peak {p_on:.3f} GiB on, {p_off:.3f} GiB off", flush=True)
        check(abs(l_on - l_off) <= BF16_TOL * abs(l_off), "11d: REMAT_TRUNK changed the loss")
        check(p_on < p_off, "11d: REMAT_TRUNK did not lower the peak memory")
        step_breakdown(dev, cfg0, batch)
        lines = {}
        for workers in (1, 4):
            cfg_w = train_config(NUM_WORKERS=workers)
            with TrainProbe() as probe:
                loop.train_az_net(cfg_w, TRAIN_IMDB, max_iters=WORKER_STEPS,
                                  output_dir=f"{out_root}/workers{workers}",
                                  imdb=imdb_over(base, roidb), device=dev)
            check_metrics(f"11d workers {workers}", probe.metrics(), ("loss",))
            # Warm-up: until every worker has delivered its first batch (their
            # start-ups end at different times).
            warmup = max(TRAIN_WARMUP, workers)
            ms, _, ips, wait = probe.summary(cfg_w.TRAIN.IMS_PER_BATCH, warmup)
            lines[workers] = (ms, ips, wait, probe.first_batches)
            built = (f"{np.mean(probe.builds) * 1e3:.1f} ms a batch on the thread" if probe.builds
                     else "each worker's latest batch in " + ", ".join(
                         f"{e['batch_s'] * 1e3:.1f}" for e in probe.worker_env.values()) + " ms")
            print(f"phase11d NUM_WORKERS {workers}: {ms:.3f} ms/step by events, {ips:.2f} img/s "
                  f"from step start to step start, prefetch wait {wait:.3f} ms/step after "
                  f"{warmup} warm-up steps ({WORKER_STEPS} steps, no mining; built {built}; "
                  f"waits {[round(w * 1e3, 1) for w in probe.waits]} ms)", flush=True)
        cfg2 = train_config(NUM_WORKERS=2)
        pf = MPPrefetcher(az_batch_builder, {"imdb_name": TRAIN_IMDB, "cfg": cfg2,
                                             "seed": cfg2.RNG_SEED, "pid": 0, "pcount": 1,
                                             "ims_local": cfg2.TRAIN.IMS_PER_BATCH}, workers=2)
        try:
            two = [pf.next() for _ in range(2)]
        finally:
            pf.close()
        four = lines[4][3]
        same = len(four) == 2 and all(
            sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
            for a, b in zip(two, four))
        print(f"phase11d first 2 batches of NUM_WORKERS 2 and 4 equal: {same}; workers "
              f"{pf.worker_env} (batch_s: host seconds to build its latest batch)", flush=True)
        check(same, "11d: the worker stream depends on the worker count")
        check(all(not e["cuda_initialized"] and not e["jax_imported"]
                  for e in pf.worker_env.values()), "11d: a prefetch worker touched CUDA or JAX")

        # (e) card against CPU.
        card_errs = train_card_vs_cpu(dev)
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    launches = launch_counts()
    print(f"phase11 launches {launches}; {time.perf_counter() - t_phase:.1f} s", flush=True)
    check(launches["nms"] > 0, "phase 11 launched no NMS kernel")
    return {"launches": launches, "err": errs, "card_vs_cpu": card_errs}


def step_breakdown(dev, cfg, batch, steps=3):
    """The AZ train step on one batch under ``torch.profiler`` (host and
    card): host ms per step, kernel ms per step, and the operators with the
    most host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aznet_tpu_torch.train.train_az import make_az_train_state, make_az_train_step

    state = make_az_train_state(cfg, device=dev)
    step = make_az_train_step(state.model)
    for _ in range(2):
        step(state, batch, cfg.RNG_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(state, batch, cfg.RNG_SEED)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    kernel = kernel_us(events) / 1e3 / steps
    top = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    print(f"phase11d step breakdown (torch.profiler, {steps} steps, host and card traced): "
          f"{wall:.2f} ms a step on the host clock, {kernel:.2f} ms of kernels a step; most host "
          "time (self ms a step, calls a step): " + "; ".join(
              f"{e.key} {e.self_cpu_time_total / 1e3 / steps:.2f} ({e.count // steps})"
              for e in top), flush=True)
    del state, step
    torch.cuda.empty_cache()


def _train_batch(kind, seed, b=2, r=8, k=5, c=4):
    """The CPU tests' batches (tests/test_torch_train.py): 64x64 images."""
    rng = np.random.RandomState(seed)
    rois = rng.uniform(0, 40, (b, r, 4)).astype(np.float32)
    rois[..., 2:] += 16.0
    batch = {"images": rng.uniform(-1, 1, (b, 64, 64, 3)).astype(np.float32), "rois": rois,
             "roi_valid": np.ones((b, r), bool)}
    if kind == "az":
        batch.update(zoom_labels=rng.randint(0, 2, (b, r)).astype(np.float32),
                     adj_labels=rng.randint(0, 2, (b, r, k)).astype(np.float32),
                     adj_targets=rng.normal(0, 0.1, (b, r, k, 4)).astype(np.float32),
                     adj_inside=np.ones((b, r, k, 4), np.float32))
    else:
        labels = rng.randint(0, c, (b, r)).astype(np.int32)
        inside = np.zeros((b, r, 4 * c), np.float32)
        for i, j in zip(*np.nonzero(labels)):
            inside[i, j, 4 * labels[i, j]:4 * labels[i, j] + 4] = 1.0
        batch.update(labels=labels, bbox_targets=inside * rng.normal(0, 0.1, inside.shape)
                     .astype(np.float32), bbox_inside=inside)
    return batch


def train_card_vs_cpu(dev):
    """One AZ and one Fast R-CNN step, smallnet float32 with DROPOUT 0, on the
    card and on the CPU from the same weights and batch: loss and metrics to
    1e-4 relative, each parameter's update to 2e-3 of its largest update (the
    float32 bounds of tests/test_torch_train.py)."""
    from aznet_tpu_torch.config import Config, cfg_from_dict
    from aznet_tpu_torch.train import train_az, train_frcnn

    cfg = cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 32, "NUM_TEMPLATES": 5, "NUM_CLASSES": 4,
                  "COMPUTE_DTYPE": "float32", "DROPOUT": 0.0},
        "TRAIN": {"LEARNING_RATE": 0.03}})
    out = {}
    for kind, make, make_step in (
            ("az", train_az.make_az_train_state, train_az.make_az_train_step),
            ("frcnn", train_frcnn.make_frcnn_train_state, train_frcnn.make_frcnn_train_step)):
        cpu = make(cfg, device="cpu")
        card = make(cfg, device=dev, state_dict=cpu.model.state_dict())
        before = {k: v.clone() for k, v in cpu.model.state_dict().items()}
        batch = _train_batch(kind, 11)
        m_cpu = make_step(cpu.model)(cpu, batch, 0)
        m_card = make_step(card.model)(card, batch, 0)
        d_m = max(abs(float(m_card[k]) - float(m_cpu[k])) / max(abs(float(m_cpu[k])), 1e-3)
                  for k in m_cpu)
        after = card.model.state_dict()
        d_u = max(float(((after[k].cpu() - before[k]) - (v - before[k])).abs().max()
                        / (v - before[k]).abs().max()) for k, v in cpu.model.state_dict().items())
        print(f"phase11e {kind} step, smallnet f32, card vs CPU: loss {float(m_card['loss']):.6f} "
              f"vs {float(m_cpu['loss']):.6f}, metrics max rel diff {d_m:.3g} (bound {F32_TOL}), "
              f"updates max diff {d_u:.3g} of the largest (bound {F32_UPDATE_TOL})", flush=True)
        check(d_m <= F32_TOL and d_u <= F32_UPDATE_TOL, f"11e: {kind} step on the card is not "
                                                         "the CPU's")
        out[kind] = (d_m, d_u)
    return out


TOOLS_CFG = "experiments/cfgs/az_vgg_w100_synthetic_hard.yml"
# The tools' imdbs: the first 32 images of synthetic_hard_train and the first
# 16 of synthetic_hard_test (each image is made from its own seed), under
# names of their own, so that proposals cover every training image and the
# test set is the whole imdb (test_net's full-run protocol).
TOOLS_TRAIN, TOOLS_TEST = "synthetic_hard_train_first32", "synthetic_hard_test_first16"
TOOLS_TRAIN_IMAGES, TOOLS_TEST_IMAGES = 32, 16
TOOLS_AZ_STEPS, TOOLS_AZ_RESUME, TOOLS_MINE = 24, 28, 8  # mining every 8 steps over 8 images
TOOLS_FRCNN_STEPS, TOOLS_SHARED_STEPS = 12, 4
TOOLS_KERNELS = ("nms", "roi_align", "conv1", "chain", "strip")  # launched by the tools' legs


def register_tools_imdbs():
    from aznet_tpu_torch.data.imdb import register_imdb
    from aznet_tpu_torch.data.synthetic import SyntheticImdb

    for name, split, seed, n in ((TOOLS_TRAIN, "train", 10, TOOLS_TRAIN_IMAGES),
                                 (TOOLS_TEST, "test", 12, TOOLS_TEST_IMAGES)):
        register_imdb(name, lambda split=split, seed=seed, n=n: SyntheticImdb(
            split=split, seed=seed, num_images=n, image_hw=RAW_HW, hard=True))


def tool_json(text):
    """The JSON object a tool printed last (``test_net``'s table, indented)."""
    lines = text.splitlines()
    return json.loads("\n".join(lines[max(i for i, line in enumerate(lines) if line == "{"):]))


def caffe_npz(path, cfg, seed=0):
    """A random ``.npz`` of the full Caffe shapes of an AZ-Net over VGG-16
    (``{layer}_W`` ``(out, in, kh, kw)`` / ``(out, in)``, ``{layer}_b``),
    from ``cfg``'s head sizes. Returns the number of floats written."""
    from aznet_tpu_torch.models.vgg import VGG16_LAYOUT

    rng = np.random.default_rng(seed)
    arrays, c_in = {}, 3
    for name, ch in VGG16_LAYOUT:
        if ch is None:
            continue
        arrays[f"{name}_W"] = rng.standard_normal((ch, c_in, 3, 3), np.float32) * 0.01
        arrays[f"{name}_b"] = rng.standard_normal(ch, np.float32) * 0.01
        c_in = ch
    fc, p, k = cfg.MODEL.FC_DIM, cfg.MODEL.POOL_SIZE, cfg.MODEL.NUM_TEMPLATES
    for name, shape in (("fc6", (fc, c_in * p * p)), ("fc7", (fc, fc)), ("zoom_score", (1, fc)),
                        ("adj_score", (k, fc)), ("adj_bbox", (4 * k, fc))):
        arrays[f"{name}_W"] = rng.standard_normal(shape, np.float32) * 0.001
        arrays[f"{name}_b"] = np.zeros(shape[0], np.float32)
    np.savez(path, **arrays)
    return sum(a.size for a in arrays.values())


def phase12_tools(dev, card):
    """The port's command-line tools (``tools_torch/``), called in-process
    through ``main(argv)`` on the card at full VGG-16 width with
    ``az_vgg_w100_synthetic_hard.yml`` on the first 32 images of
    ``synthetic_hard_train`` and the first 16 of ``synthetic_hard_test``:
    (a) ``train_net --net az`` 24 steps, mining every 8 over 8 images, then
    a resume to 28; (b) ``propose_net --batched`` with ``'align_pallas'`` +
    ``FUSE_CONV1``; (c) ``train_net --net frcnn --proposals`` 12 steps, then
    4 with ``--init-trunk-from`` the AZ run (its trunk byte-identical after);
    (d) ``test_net --mode recall --batched``, with ``--int8``, with
    ``--refine``; (e) ``test_net --mode detect --batched --share-trunk`` on
    the shared-trunk Fast R-CNN (the fused program); (f) ``demo``; (g)
    ``time_net --batch 2 --reps 3`` inside ``utils/profiling.trace``; (h)
    ``convert_caffe`` on a random ``.npz`` of VGG-16's full Caffe shapes, then
    ``test_net`` from that snapshot. Every launch count is set to 0 at the
    start and read at the end; each leg prints its wall time and launches;
    the first launch of each kernel is held against its plain version.
    Returns the launches and errors."""
    import importlib
    import io
    import pickle
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from aznet_tpu_torch import kernels
    from aznet_tpu_torch.eval import detection as tdet
    from aznet_tpu_torch.ops.cuda import launch_counts, set_launch_counts
    from aznet_tpu_torch.utils import profiling
    from aznet_tpu_torch.utils.checkpoint import Checkpointer
    from tools_torch import _common

    t_phase = time.perf_counter()
    register_tools_imdbs()
    cfg_path = str(Path(__file__).resolve().parent / TOOLS_CFG)
    cfg = _common.load_config(cfg_path)
    out = tempfile.mkdtemp(prefix="aznet_tools_")
    base = ["--cfg", cfg_path]
    fused = ["MODEL.POOLING_MODE", "align_pallas", "MODEL.FUSE_CONV1", "True"]
    legs, fused_calls = {}, []

    def tool(leg, name, argv):
        """``tools_torch.<name>.main(argv)``: its wall time, launches and
        standard output (echoed, the long progress lines left out)."""
        mod = importlib.import_module(f"tools_torch.{name}")
        before = launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        text = buf.getvalue()
        for line in text.splitlines():
            if not line.startswith(("propose_batched", "refined")):
                print(f"phase12{leg}   {line}")
        print(f"phase12{leg} {name} {' '.join(argv)}: {s:.2f} s ({card}); launches {delta}",
              flush=True)
        check(rc == 0, f"phase12{leg}: {name} returned {rc}")
        legs.setdefault(leg, []).append((name, s, delta))
        return text, delta

    set_launch_counts()
    try:
        with kernels.recording(first_only=True) as recorded, \
                wrapped(tdet, "detect_all_fused", before=lambda *a: fused_calls.append(1)):
            # (a) AZ-Net with mining, then a resume.
            az = f"{out}/az"
            mine = ["TRAIN.MINE_INTERVAL", str(TOOLS_MINE), "TRAIN.MINE_IMAGES", str(TOOLS_MINE)]
            text, d = tool("a", "train_net", ["--net", "az", "--imdb", TOOLS_TRAIN, "--iters",
                                              str(TOOLS_AZ_STEPS), "--output", az] + base
                           + ["--set"] + mine)
            harvests = -(-TOOLS_AZ_STEPS // TOOLS_MINE)  # at steps 0, 8, 16: one NMS an image
            check(d["nms"] == harvests * TOOLS_MINE and "done; checkpoints in" in text,
                  f"12a: {d['nms']} NMS launches in {harvests} harvests of {TOOLS_MINE} images")
            text, _ = tool("a", "train_net", ["--net", "az", "--imdb", TOOLS_TRAIN, "--iters",
                                              str(TOOLS_AZ_RESUME), "--output", az] + base
                           + ["--set"] + mine)
            check(f"resumed from step {TOOLS_AZ_STEPS}" in text
                  and Checkpointer(az).all_steps() == [TOOLS_AZ_STEPS, TOOLS_AZ_RESUME],
                  f"12a: the resume ({Checkpointer(az).all_steps()})")

            # (b) proposals with the ROI-align and conv1 kernels.
            props = f"{out}/proposals.pkl"
            _, d = tool("b", "propose_net", ["--imdb", TOOLS_TRAIN, "--ckpt", az, "--batched",
                                             "--out", props] + base + ["--set"] + fused)
            check(all(d[k] > 0 for k in ("nms", "roi_align", "conv1")), f"12b: launches {d}")
            from aznet_tpu_torch.data.imdb import get_imdb

            with open(props, "rb") as f:
                plist = pickle.load(f)
            check(len(plist) == TOOLS_TRAIN_IMAGES, f"12b: {len(plist)} proposal arrays")
            check_proposals("12b", plist, get_imdb(TOOLS_TRAIN), cfg.SEAR.NUM_PROPOSALS)

            # (c) Fast R-CNN on those proposals, then one on the AZ trunk (frozen).
            fr, shared = f"{out}/frcnn", f"{out}/frcnn_shared"
            tool("c", "train_net", ["--net", "frcnn", "--imdb", TOOLS_TRAIN, "--iters",
                                    str(TOOLS_FRCNN_STEPS), "--output", fr, "--proposals",
                                    props] + base)
            text, _ = tool("c", "train_net", ["--net", "frcnn", "--imdb", TOOLS_TRAIN, "--iters",
                                              str(TOOLS_SHARED_STEPS), "--output", shared,
                                              "--proposals", props, "--init-trunk-from", az]
                           + base)
            check("trunk frozen" in text, "12c: --init-trunk-from did not freeze the trunk")
            a_params = Checkpointer(f"{az}/deploy").restore({"params": 0})[0]["params"]
            s_params = Checkpointer(f"{shared}/deploy").restore({"params": 0})[0]["params"]
            trunk = [k for k in a_params if k.startswith("trunk.")]
            same = all(torch.equal(a_params[k], s_params[k]) for k in trunk)
            print(f"phase12c trunk of the --init-trunk-from run byte-identical to the AZ run's "
                  f"({len(trunk)} tensors): {same}", flush=True)
            check(same and trunk, "12c: the shared trunk moved")

            # (d) recall: one-shot, int8, refined.
            recall = ["--mode", "recall", "--imdb", TOOLS_TEST, "--ckpt", az, "--batched",
                      "--batch-size", "8"] + base
            tables = {}
            for tag, extra in (("bf16", []), ("int8", ["--int8"]),
                               ("refined", ["--refine", "--frcnn-ckpt", fr])):
                text, d = tool("d", "test_net", recall + extra)
                tables[tag] = tool_json(text)
                print(f"phase12d recall {tag}: {check_recall(tag, tables[tag])}", flush=True)
                if tag == "int8":
                    check(d["chain"] > 0 and d["strip"] > 0, f"12d: int8 launches {d}")

            # (e) the fused shared-trunk detect program.
            text, d = tool("e", "test_net", ["--mode", "detect", "--imdb", TOOLS_TEST, "--ckpt", az,
                                             "--frcnn-ckpt", shared, "--batched", "--batch-size",
                                             "8", "--share-trunk", "--output", f"{out}/eval"]
                           + base + ["--set"] + fused)
            aps = tool_json(text)
            check(fused_calls == [1] and all(0.0 <= v <= 1.0 for v in aps.values()),
                  f"12e: {len(fused_calls)} fused detect calls, {aps}")
            check(all(d[k] > 0 for k in ("nms", "roi_align", "conv1")), f"12e: launches {d}")

            # (f) demo on one image.
            text, d = tool("f", "demo", ["--ckpt", az, "--frcnn-ckpt", fr, "--out",
                                         f"{out}/demo.png"] + base + ["--set"] + fused)
            check("im_propose:" in text and "im_detect:" in text and d["nms"] > 0, "12f: demo")

            # (g) stage timings under the profiler.
            with profiling.trace(f"{out}/trace") as prof:
                text, _ = tool("g", "time_net", ["--batch", "2", "--reps", "3", "--raw-hw",
                                                  *map(str, RAW_HW), "--canvas",
                                                  *map(str, CANVAS)] + base)
            from torch.autograd import DeviceType

            kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            with open(f"{out}/trace/trace.json") as f:
                events = json.load(f)["traceEvents"]
            n_kernel = sum(e.get("cat") == "kernel" for e in events)
            print(f"phase12g trace: {len(events)} events, {n_kernel} CUDA kernel events, "
                  f"{sum(e.self_device_time_total for e in kernels) / 1e3:.1f} ms of card time "
                  f"in {len(kernels)} kinds", flush=True)
            check(n_kernel > 0 and kernels, "12g: the trace holds no CUDA kernel event")
            check(all(f"{s:12s}:" in text for s in ("preprocess", "trunk", "search",
                                                   "end-to-end")), "12g: a stage is missing")

            # (h) Caffe weights at VGG-16's full shapes.
            npz, conv = f"{out}/vgg16_caffe.npz", f"{out}/converted"
            t0 = time.perf_counter()
            n = caffe_npz(npz, cfg)
            print(f"phase12h random Caffe .npz, {n} floats, written in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            tool("h", "convert_caffe", ["--npz", npz, "--net", "az", "--out", conv] + base)
            text, _ = tool("h", "test_net", ["--mode", "recall", "--imdb", TOOLS_TEST, "--ckpt",
                                             conv, "--batched", "--batch-size", "8"] + base)
            print(f"phase12h recall from the converted snapshot: "
                  f"{check_recall('converted', tool_json(text))}", flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    launches = launch_counts()
    print(f"phase12 tools launches {launches}; {time.perf_counter() - t_phase:.1f} s", flush=True)
    check(all(launches[k] > 0 for k in TOOLS_KERNELS), f"a kernel never ran in the tools: "
                                                       f"{launches}")
    check(launches["iou"] == 0, f"the IoU kernel ran in the tools: {launches}")

    errs = hold("phase12", recorded, "the tools' first inputs")
    check(sorted(errs) == ["chain", "conv1", "nms", "roi_align", "search_level", "search_seed",
                           "search_select", "strip"], f"recorded {sorted(errs)}")
    return {"launches": launches, "err": errs, "legs": legs}


MESH_REPS = 5  # timed calls of each propose and detect function a round, after 1
MESH_TRAIN_STEPS = 3  # timed train steps of each kind a round, after 1
MESH_ROUNDS = 3  # alternating rounds (plain, mesh); the medians are reported


def same_bits(tag, got, want):
    """Checks that two tuples of tensors are equal bit for bit."""
    import torch

    check(len(got) == len(want) and all(
        g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
        for g, w in zip(got, want)), f"{tag}: the mesh path is not bit for bit the plain path")


def phase13_mesh(dev, card):
    """The mesh paths at world size 1 on NCCL, full VGG-16 width: ``make_mesh(1)``
    on the card, then, with every launch count and collective count set to 0
    just before and read just after: (a) ``make_sharded_propose`` (bf16) on
    phase 2's two raw 375x500 images on 608x800, again with
    ``shard_regions=True``, and ``make_latency_propose`` on image 0; (b) the
    sharded propose of the int8 net (phase 4's calibration); (c)
    ``make_sharded_detect`` with the detect configuration on (a)'s 300
    proposals an image; (d) one AZ train step on ``{data 1, model 1}`` from
    phase 11's seeded state on phase 11d's batch; (e) ``train_net --mesh 1``
    for 2 steps, mining 2 images at step 0. Each output is held bit for bit
    against the plain path's on the same inputs (run before the counts are
    set to 0), each kernel's first launch against its plain version; the
    collectives must have run; then each mesh call is timed beside its plain
    path, and the host's time to issue one small collective. The group is
    destroyed at the end."""
    import io
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from aznet_tpu_torch import api, kernels
    from aznet_tpu_torch.config import Config
    from aznet_tpu_torch.data.imdb import get_imdb
    from aznet_tpu_torch.data.minibatch import fixed_canvas, get_az_minibatch
    from aznet_tpu_torch.ops.cuda import launch_counts, set_launch_counts
    from aznet_tpu_torch.parallel import make_mesh
    from aznet_tpu_torch.parallel.inference import (make_latency_propose, make_sharded_detect,
                                                    make_sharded_propose)
    from aznet_tpu_torch.parallel.mesh import COLLECTIVES, all_gather, all_reduce
    from aznet_tpu_torch.train.train_az import make_az_train_state, make_az_train_step
    from aznet_tpu_torch.utils.checkpoint import Checkpointer
    from tools_torch import train_net

    t_phase = time.perf_counter()
    register_tools_imdbs()
    tools_cfg = str(Path(__file__).resolve().parent / TOOLS_CFG)
    check(not dist.is_initialized(), "phase13: a process group exists before make_mesh(1)")
    mesh = make_mesh(1, device=dev)
    out_dir = tempfile.mkdtemp(prefix="aznet_mesh_")
    try:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        check(dist.get_backend() == backend and dist.get_world_size() == 1
              and mesh.shape == {"data": 1, "model": 1} and mesh.device == dev,
              f"phase13: mesh {mesh.shape} on {mesh.device}, backend {dist.get_backend()}")
        print(f"phase13 make_mesh(1): {mesh.shape} on {mesh.device}, backend "
              f"{dist.get_backend()}, world {dist.get_world_size()}", flush=True)

        # The plain paths first, outside the counted window.
        images = torch.from_numpy(np.random.RandomState(0).randint(
            0, 256, (BATCH,) + RAW_HW + (3,)).astype(np.uint8)).to(dev)
        net = build_net("phase13", Config(), dev)
        net8 = calibrated_int8("phase13", net, dev)
        fr = api.build_frcnn_net(detect_config(), device=dev)
        plain = {"propose": api.make_propose_batch(net.model, net.cfg, CANVAS),
                 "int8": api.make_propose_batch(net8.model, net8.cfg, CANVAS),
                 "detect": api.make_detect_batch(fr.model, fr.cfg, CANVAS)}
        want = {"propose": plain["propose"](images), "int8": plain["int8"](images),
                "latency": tuple(t[0] for t in plain["propose"](images[:1]))}
        boxes = want["propose"][0].contiguous()
        want["detect"] = plain["detect"](images, boxes)
        cfg_t = train_config()
        imdb = get_imdb(TOOLS_TRAIN)  # its first images are synthetic_hard_train's
        tb = get_az_minibatch(imdb, imdb.roidb[:2], cfg_t, np.random.RandomState(0),
                              fixed_canvas(imdb, cfg_t))
        one = make_az_train_state(cfg_t, device=dev)
        init = {k: v.clone() for k, v in one.model.state_dict().items()}
        one_step = make_az_train_step(one.model)
        want_m = one_step(one, tb, cfg_t.RNG_SEED)
        torch.cuda.synchronize()

        mesh_fns = {
            "propose": make_sharded_propose(net.model, net.cfg, CANVAS, mesh),
            "region": make_sharded_propose(net.model, net.cfg, CANVAS, mesh, shard_regions=True),
            "latency": make_latency_propose(net.model, net.cfg, CANVAS, mesh),
            "int8": make_sharded_propose(net8.model, net8.cfg, CANVAS, mesh),
            "detect": make_sharded_detect(fr.model, fr.cfg, CANVAS, mesh)}
        mst = make_az_train_state(cfg_t, device=dev, mesh=mesh)
        mesh_step = make_az_train_step(mst.model, mesh=mesh)

        set_launch_counts()
        COLLECTIVES.update(all_gather=0, all_reduce=0)
        got = {}
        with kernels.recording(first_only=True) as recorded:
            for key in ("propose", "region", "int8"):
                got[key] = mesh_fns[key](images)
            got["latency"] = mesh_fns["latency"](images[0])
            got["detect"] = mesh_fns["detect"](images, boxes)
            got_m = mesh_step(mst, tb, cfg_t.RNG_SEED)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = train_net.main(["--net", "az", "--imdb", TOOLS_TRAIN, "--iters", "2",
                                     "--output", f"{out_dir}/tool", "--mesh", "1", "--cfg",
                                     tools_cfg, "--set", "TRAIN.MINE_INTERVAL", "2",
                                     "TRAIN.MINE_IMAGES", "2"])
            torch.cuda.synchronize()
        launches = launch_counts()
        calls = dict(COLLECTIVES)
        text = buf.getvalue()
        print(f"phase13 mesh launches {launches}; collectives {calls}", flush=True)

        for key in ("propose", "region", "int8"):
            same_bits(f"13 {key}", got[key], want["int8" if key == "int8" else "propose"])
        same_bits("13 latency", got["latency"], want["latency"])
        same_bits("13 detect", got["detect"], want["detect"])
        print("phase13 sharded, region and latency propose (bf16), int8 sharded propose and "
              "sharded detect: bit for bit the plain paths", flush=True)
        # (d) the train step: metrics and every updated parameter.
        d_metric = max(abs(float(got_m[k]) - float(want_m[k])) for k in want_m)
        p_one, p_mesh = one.model.state_dict(), mst.snapshot()["params"]
        diff = max(float((p_mesh[k] - v).abs().max()) for k, v in p_one.items())
        scale = max(float((v - init[k]).abs().max()) for k, v in p_one.items())
        bits = d_metric == 0.0 and diff == 0.0
        print(f"phase13d train step on {{data 1, model 1}} against the non-mesh step: metrics "
              f"max diff {d_metric}, parameters max diff {diff} (largest update {scale:.6g}); "
              f"bit for bit: {bits}; loss {float(got_m['loss']):.6f}", flush=True)
        # Not bit for bit would be float32 reduction order (PERF.md): within
        # 1e-3 of the largest update, as the CPU tests hold the mesh step.
        check(diff <= 1e-3 * scale and d_metric <= 1e-4 * abs(float(want_m["loss"])),
              "13d: the mesh train step is not the plain step")
        del init
        check(rc == 0 and "mesh: {'data': 1, 'model': 1}" in text and "[az 2]" in text
              and "[az] mined search regions for 2 images at step 0" in text
              and Checkpointer(f"{out_dir}/tool").all_steps() == [2],
              f"13e: train_net --mesh 1 returned {rc}:\n{text[-2000:]}")
        print("phase13e train_net --mesh 1: 2 steps, a harvest of 2 images, snapshot 2",
              flush=True)
        check(calls["all_gather"] > 0 and calls["all_reduce"] > 0,
              f"13f: NCCL collectives {calls}")
        for k in ("nms", "roi_align", "conv1", "chain", "strip", "search_level"):
            check(launches[k] > 0, f"13g: {k} kernel never launched on the mesh paths")
        check(launches["iou"] == 0, f"13g: the IoU kernel launched: {launches}")

        errs = hold("phase13g", recorded, "the mesh paths' first inputs")

        # Times: each mesh call beside its plain path, in this call, in
        # alternating rounds (the host-bound search moves between rounds).
        timed = {}
        ips = cfg_t.TRAIN.IMS_PER_BATCH
        for key, p_fn, m_fn, n_img, reps in (
                ("propose", lambda: plain["propose"](images), lambda: mesh_fns["propose"](images),
                 BATCH, MESH_REPS),
                ("region", lambda: plain["propose"](images), lambda: mesh_fns["region"](images),
                 BATCH, MESH_REPS),
                ("latency", lambda: plain["propose"](images[:1]),
                 lambda: mesh_fns["latency"](images[0]), 1, MESH_REPS),
                ("int8", lambda: plain["int8"](images), lambda: mesh_fns["int8"](images), BATCH,
                 MESH_REPS),
                ("detect", lambda: plain["detect"](images, boxes),
                 lambda: mesh_fns["detect"](images, boxes), BATCH, MESH_REPS),
                ("train_step", lambda: one_step(one, tb, cfg_t.RNG_SEED),
                 lambda: mesh_step(mst, tb, cfg_t.RNG_SEED), ips, MESH_TRAIN_STEPS)):
            rounds = [(cuda_ms(p_fn, reps, 1), cuda_ms(m_fn, reps, 1))
                      for _ in range(MESH_ROUNDS)]
            p_ms, m_ms = (float(np.median(v)) for v in zip(*rounds))
            timed[key] = {"ms": m_ms, "img_s": n_img / m_ms * 1e3, "plain_ms": p_ms,
                          "plain_img_s": n_img / p_ms * 1e3,
                          "rounds_ms": [[round(a, 4), round(b, 4)] for a, b in rounds]}
        # The host's time to issue one collective of 64 floats, back to back:
        # the counted wrappers, and PyTorch's call alone.
        x64 = torch.zeros(64, device=dev)
        out64 = torch.empty(64 * dist.get_world_size(), device=dev)
        group = mesh.group("model")
        issue_us = {"all_gather": host_us(lambda: all_gather(x64, group), 200),
                    "all_reduce": host_us(lambda: all_reduce(x64, group), 200),
                    "torch_all_gather_into_tensor": host_us(
                        lambda: dist.all_gather_into_tensor(out64, x64, group=group), 200)}
        print(json.dumps({"mesh": {"card": card, "world": 1, "backend": dist.get_backend(),
                                   "calls": timed, "collectives": calls,
                                   "issue_host_us": issue_us, "launches": launches}}),
              flush=True)
        set_launch_counts(launches)  # the timing runs launched again: the window's counts
    finally:
        dist.destroy_process_group()
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"phase13 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": launches, "err": errs, "calls": timed}


def alternating_ms(fns, rounds=3):
    """{name: median over ``rounds`` of the CUDA-event ms a call}, the
    functions timed in turn within each round."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(cuda_ms(fn, 5, 2))
    return {name: float(np.median(t)) for name, t in times.items()}


def int8_variant(tag, net8, dev, **model):
    """Phase 4's calibrated int8 net rebuilt from the same float32
    parameters and scales with other MODEL settings."""
    import dataclasses

    cfg = dataclasses.replace(net8.cfg, MODEL=dataclasses.replace(net8.cfg.MODEL, **model))
    return build_net(tag, cfg, dev, state_dict=net8.params)


def phase14a_chain_from_conv1_2(dev, int8):
    """The int8 VGG-16 propose path with the trunk from conv1_2: launches,
    every conv input against the plain version, proposals, cosine against the
    bf16 trunk, and the trunk timed against the trunk from conv2_2."""
    import torch

    net8, blobs = int8["net"], int8["blobs"]
    net12 = int8_variant("phase14a", net8, dev, INT8_CHAIN_FROM="conv1_2")
    trunk = net12.model.trunk
    check(trunk.int8_bf16_prefix == ("conv1_1",), f"the trunk from conv1_2 kept the prefix "
                                                  f"{trunk.int8_bf16_prefix}")

    records = []
    p = phase2_propose(dev, net12, "phase14a", counters=("chain", "strip"), records=records)
    counts = {e: p["launches"][e] for e in ("chain", "strip")}
    check(counts == {"chain": 8, "strip": 16},
          f"trunk from conv1_2: launches {counts}, expected chain 8 and strip 16 in 2 trunk calls")
    shapes = {(r.name, tuple(r.args[0].shape)) for r in records if r.name in counts}
    for entry, shape in (("chain", (BATCH,) + CANVAS + (64,)),
                         ("strip", (BATCH, CANVAS[0] // 2, CANVAS[1] // 2, 64))):
        check((entry, shape) in shapes, f"no {entry} launch at {shape} on the path")
    with torch.inference_mode():
        f12 = net12.model.features(blobs).float()
        cos = cosine(int8["bf16_feat"], f12)
        t = alternating_ms({
            "from conv1_2": lambda: net12.model.features(blobs),
            "from conv2_2": lambda: net8.model.features(blobs),
            "prefix conv1_1": lambda: trunk.int8_prefix(blobs),
            "prefix conv1_1..conv2_1": lambda: net8.model.trunk.int8_prefix(blobs)})
    print(f"phase14a int8 from conv1_2 vs bf16 trunk features: cosine {cos:.6f}", flush=True)
    check(cos > 0.98, f"the int8 trunk from conv1_2 drifts from the bf16 trunk: cosine {cos}")
    print(f"phase14a int8 trunk at b={BATCH}, medians of 3 alternating rounds (events): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
          + f"; propose {p['ips']:.2f} img/s vs {int8['ips']:.2f} from conv2_2", flush=True)
    return {"launches": p["launches"], "err": p["err"]}


def phase14b_xla(dev, int8):
    """The int8 propose path under ``INT8_BACKEND='xla'``: no conv kernel, 30
    ``_int_mm`` calls a trunk call; the first int8 layer's codes and the
    trunk's output against the ``'pallas'`` trunk's."""
    import torch

    from aznet_tpu_torch.models.vgg import VGG16_LAYOUT
    from aznet_tpu_torch.ops import conv_int8 as tconv

    net8, blobs = int8["net"], int8["blobs"]
    netx = int8_variant("phase14b", net8, dev, INT8_BACKEND="xla")
    int_mm = [0]

    def tick(*_):
        int_mm[0] += 1

    p = phase2_propose(dev, netx, "phase14b", counters=("chain", "strip"),
                       recorders=[wrapped(torch, "_int_mm", before=tick)])
    counts = {**p["launches"], "_int_mm": int_mm[0]}
    check(counts["chain"] == 0 and counts["strip"] == 0, f"'xla' launched conv kernels: {counts}")
    with torch.inference_mode(), wrapped(torch, "_int_mm", before=tick):
        int_mm[0] = 0
        fx = netx.model.features(blobs).float()
        trunk_mm = int_mm[0]
    check(trunk_mm == 30, f"'xla' trunk made {trunk_mm} _int_mm calls, expected 30")
    tr8, trx = net8.model.trunk, netx.model.trunk
    scales = dict(zip([n for n, ch in VGG16_LAYOUT if ch is not None], tr8.int8_scales))
    with torch.inference_mode():
        codes = tr8.int8_prefix(blobs)
        check(torch.equal(codes, trx.int8_prefix(blobs)), "'xla' and 'pallas' prefixes differ")
        s_x, s_out = scales["conv2_1"], scales["conv2_2"]
        a = tconv.conv3x3_int8(codes, s_x, tr8._int8_layers["conv2_2"], s_out, pool=True)
        b = tconv.max_pool_2x2(tconv.conv3x3_int8_dx(codes, s_x, *trx._int8_layers["conv2_2"],
                                                     s_out))
        d = (a.int() - b.int()).abs()
        f8 = net8.model.features(blobs).float()
        cos = cosine(f8, fx)
        t = alternating_ms({"'xla'": lambda: netx.model.features(blobs),
                            "'pallas'": lambda: net8.model.features(blobs)})
    share = (d > 0).float().mean().item()
    print(f"phase14b 'xla': _int_mm {trunk_mm} a trunk call, {counts['_int_mm']} on the propose "
          f"path with the int8 heads; conv2_2 (first int8 layer, pooled) codes differ from the "
          f"'pallas' chain on {share:.3e} of {d.numel()} (max {d.max().item()}); trunk cosine "
          f"against 'pallas' {cos:.7f}; trunk medians of 3 alternating rounds (events) "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
          + f"; propose {p['ips']:.2f} img/s vs 'pallas' {int8['ips']:.2f}", flush=True)
    check(cos > 0.999, f"'xla' trunk drifts from the 'pallas' trunk: cosine {cos}")
    return {"launches": p["launches"], "err": p["err"]}


def conv1_f32_sass():
    """The float32 conv1 kernel's SASS in the built library (``cuobjdump
    -sass``): {opcode: count} of its instructions, and its HGMMA lines."""
    import re
    from collections import Counter

    from aznet_tpu_torch import _build

    _, text = sass_loop(_build.build(), "conv1_fused_f32_kernel")
    ops = Counter()
    hgmma = []
    for line in text.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([.\w]*)", line)
        if m:
            ops[m.group(1)] += 1
            if m.group(1) == "HGMMA":
                hgmma.append(line.split(";")[0].split("*/", 1)[1].strip())
    return ops, hgmma


def phase14c_conv1_f32(dev):
    """The float32 fused conv1 kernel's SASS (HGMMA on TF32 operands), the
    kernel alone at b=2 608x800x64, then a float32 VGG-16 net with
    ``FUSE_CONV1`` and ``'align_pallas'`` through the propose path, against
    the same net unfused."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from aznet_tpu_torch.config import Config, cfg_from_dict
    from aznet_tpu_torch.ops import conv1_fused as tconv1
    from aznet_tpu_torch.ops.cuda import conv1_kernel
    from aznet_tpu_torch.utils.precision import float32_precision

    ops, hgmma = conv1_f32_sass()
    print(f"phase14c conv1_fused_f32 SASS: {sum(ops.values())} instructions, "
          + ", ".join(f"{op} {n}" for op, n in ops.most_common(16))
          + f"; HGMMA forms: {sorted({h.split()[0] for h in hgmma})}", flush=True)
    check(hgmma and all("TF32" in h for h in hgmma),
          f"the float32 conv1 kernel's SASS has no HGMMA on TF32 operands: {hgmma[:3]}")

    y, w12, b12 = (t.float() for t in conv1_case(dev))
    w_k = tconv1.kernel_layout_f32(w12)
    run = lambda: conv1_kernel.conv1_2_pool_cuda_f32(y, w_k, b12)
    plain = lambda: tconv1.conv1_2_pool_reference(y, w12, b12)
    got = run()
    torch.cuda.synchronize()
    ok, errs = tconv1.float64_errors(got, y, w12, b12)
    err = (got - plain()).abs().max().item()
    y_nchw, w_cl = y.permute(0, 3, 1, 2), w12.contiguous(memory_format=torch.channels_last)

    def library():
        with float32_precision():
            return F.max_pool2d(torch.relu(F.conv2d(y_nchw, w_cl, b12, padding=1)), 2)

    k_ms, p_ms, l_ms = cuda_ms(run, 10, 2), cuda_ms(plain, 3, 1), cuda_ms(library, 10, 2)
    (k_us, seen), l_us = launch_us(run, "conv1_fused_f32_kernel"), device_us(library, "")
    check(k_us is not None, "the profiler saw no float32 conv1 kernel")
    nbytes = (y.numel() + w12.numel() + 64 + got.numel()) * 4
    b_ms, b_by = bound(nbytes, 3 * CONV1_FLOP, "tf32")
    tf = CONV1_FLOP / k_us / 1e6
    print(f"phase14c conv1_fused_f32 {BATCH}x{CANVAS[0]}x{CANVAS[1]}x64 f32: against float64 "
          f"kernel {errs['kernel']:.4e}, plain {errs['plain']:.4e} (ratio "
          f"{errs['kernel'] / errs['plain']:.3f}), max|kernel - plain| / max|plain| "
          f"{errs['rel']:.3e}, max_abs_err {err}; kernel {k_ms:.4f} ms by events, device "
          f"{k_us:.2f} us a launch over the {seen} of 20 the profiler saw "
          f"({tf:.1f} TFLOP/s of conv1's, {f32_shares(k_us)}), plain {p_ms:.4f} ms, library "
          f"(cuDNN f32 conv2d + relu + max_pool2d, TF32 off) {l_ms:.4f} ms (device {l_us} us), "
          f"bound {b_ms * 1e3:.2f} us ({b_by}: 3 x {CONV1_FLOP / 1e9:.1f} GFLOP at the TF32 "
          f"peak)", flush=True)
    check(ok, f"float32 conv1 kernel outside its float64 bound: {errs}")

    cfg = cfg_from_dict(Config(), {"MODEL": {"COMPUTE_DTYPE": "float32",
                                             "POOLING_MODE": "align_pallas", "FUSE_CONV1": True}})
    netf = build_net("phase14c", cfg, dev)
    records = []
    p = phase2_propose(dev, netf, "phase14c", counters=("conv1_f32",), records=records)
    counts, blobs = p["launches"], p["blobs"]
    check(counts["conv1_f32"] == 2, f"float32 conv1 launched {counts} times in 2 trunk calls")
    first = next(r for r in records if r.name == "conv1_f32")
    y0, w0, bias0 = first.args
    w12_0 = tconv1.unpack_kernel_layout_f32(w0, bias0.shape[0])
    ok0, errs0 = tconv1.float64_errors(first.out, y0, w12_0, bias0)
    check(ok0, f"float32 conv1 kernel outside its float64 bound on the path's input: {errs0}")
    del records, first, y0
    netu = build_net("phase14c unfused", dataclasses.replace(
        cfg, MODEL=dataclasses.replace(cfg.MODEL, FUSE_CONV1=False)), dev,
        state_dict=netf.params)
    with torch.inference_mode():
        ff, fu = netf.model.features(blobs), netu.model.features(blobs)
    rel = ((ff - fu).abs().max() / fu.abs().max()).item()
    print(f"phase14c float32 FUSE_CONV1 net: {counts['conv1_f32']} launches on the propose path "
          f"({p['ips']:.2f} img/s); the path's first input against float64 {errs0}; trunk "
          f"features fused vs unfused max rel err {rel:.3e}", flush=True)
    check(rel <= 1e-5, f"float32 FUSE_CONV1 trunk disagrees with the unfused trunk: {rel}")
    return {"err": {**p["err"], "conv1_f32": max(err, p["err"]["conv1_f32"])}, "errs": errs,
            "ms": k_ms, "device_us": k_us, "plain_ms": p_ms, "library_ms": l_ms,
            "bound": (b_ms, b_by), "launches": counts}


def phase14d_card_vs_cpu(dev, int8):
    """The two int8 walks on the card against the CPU: ``'xla'`` at WIDTH
    0.125 (phase 4's reference), and the trunk from conv1_2 at full width on
    two 64x64 images with phase 4's calibrated weights and scales."""
    import torch

    from aznet_tpu_torch.models.vgg import VGG16Trunk

    phase4_reference(dev, backend="xla")
    tr8 = int8["net"].model.trunk
    trunks = []
    for d in ("cpu", dev):
        t = VGG16Trunk(int8_mode=True, int8_scales=tr8.int8_scales, int8_chain_from="conv1_2")
        t.load_state_dict({k: v.float() for k, v in tr8.state_dict().items()})
        t.to(d).eval().prepare_int8()
        trunks.append(t)
    x = torch.from_numpy(np.random.RandomState(2).uniform(-120, 120, (2, 64, 64, 3))
                         .astype(np.float32))
    int8_card_vs_cpu("phase14d trunk from conv1_2 (VGG-16 full width, 2x64x64, card vs CPU)",
                     trunks[0], trunks[1], x, dev, {"chain": 4, "strip": 8})


def phase14_settings(dev, int8):
    """Phase 14: the last settings the port took up: the int8 trunk from
    conv1_2, ``INT8_BACKEND='xla'`` and float32 ``FUSE_CONV1``."""
    t0 = time.perf_counter()
    out = {"c12": phase14a_chain_from_conv1_2(dev, int8), "xla": phase14b_xla(dev, int8),
           "conv1_f32": phase14c_conv1_f32(dev)}
    phase14d_card_vs_cpu(dev, int8)
    print(f"phase14 {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# -- phase 15: NMS beyond 8192, and the measurement tools --------------------

NMS_LARGE_CASES = [  # name, seed, B, N, extent, tie streams, IoU, held against
    ("large_1x8193", 21, 1, 8193, 2828.0, 0, 0.5, "plain"),
    ("ties_1x16384", 22, 1, 16384, 4000.0, 1, 0.7, "plain"),
    ("large_2x20000", 23, 2, 20000, 4419.0, 0, 0.5, "plain"),
    ("large_1x32768", 24, 1, 32768, 5657.0, 0, 0.5, "plain"),
    # The plain version's float IoU matrices take 17 GB each at 65536: the
    # host library's greedy NMS on distinct scores (its tie order is not the
    # folded key's) holds this one.
    ("large_1x65536", 25, 1, 65536, 8000.0, 0, 0.5, "host"),
]


def phase15a_nms_large(dev):
    """The NMS kernel's large route (sort widths 16384 .. 65536) against the
    plain version on the card, bit for bit (one case tie-heavy with +-0,
    subnormal and invalid rows, as phase 1), and at 1 x 65536 against the
    host library's greedy NMS; each timed beside its bound. Returns
    ``(max_abs_err, {case: times})``."""
    import torch

    from aznet_tpu_torch.ops import nms as tnms

    err, cases = 0.0, {}
    for name, seed, bsz, n, extent, ties, iou, ref in NMS_LARGE_CASES:
        boxes, scores, valid = nms_inputs(seed, bsz, n, extent, ties, dev)
        if ref == "host":
            scores = torch.from_numpy(np.random.RandomState(seed).permutation(bsz * n).reshape(
                bsz, n).astype(np.float32) / (bsz * n)).to(dev)
        got = tnms.nms_mask_batched(boxes, scores, iou, valid)
        t0 = time.perf_counter()
        if ref == "plain":
            want = tnms.nms_mask_reference(boxes, scores, iou, valid)
        else:
            want = torch.zeros_like(got)
            for b in range(bsz):
                dets = torch.cat([boxes[b], scores[b, :, None]], 1).cpu().numpy()
                want[b, tnms.nms(dets, iou)] = True
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        diff = (got.float() - want.float()).abs().max().item()
        err = max(err, diff)
        kept = int(want.sum())
        check(diff == 0.0, f"phase15a {name}: NMS kernel disagrees with the {ref} version")
        check(0 < kept < int(valid.sum()), f"phase15a {name}: degenerate case, kept {kept}")
        t = nms_kernel_times(boxes, scores, iou, valid)
        t["plain_ms"] = cuda_ms(lambda: tnms.nms_mask_reference(boxes, scores, iou, valid),
                                1, 1) if ref == "plain" else None
        t["held_against"], t["kept"] = ref, kept
        t["bound_ms"], t["bound_by"] = nms_bound(bsz, n)
        cases[name] = t
        plain = f"{t['plain_ms']:.4f} ms" if t["plain_ms"] is not None else "not measured"
        print(f"phase15a {name}: kept {kept}/{bsz * n}, max_abs_err {diff} against the {ref} "
              f"version ({ref_s:.2f} s); kernel {nms_times_line(t)}; plain {plain}; "
              f"{bsz * n / t['ms'] / 1e3:.2f} Mboxes/s; bound {t['bound_ms'] * 1e3:.3f} us "
              f"({t['bound_by']})", flush=True)
    return err, cases



def run_tool(tag, name, argv, card, env=None):
    """``tools_torch.<name>.main(argv)`` in this process under the environment
    variables ``env``, with every launch count set to 0 just before and read
    just after, and the first launch of each kernel held against its plain
    version. Echoes the tool's output; returns ``(output, launches, errs)``."""
    import importlib
    import io
    import os

    import torch

    from aznet_tpu_torch import kernels
    from aznet_tpu_torch.ops.cuda import launch_counts, set_launch_counts

    mod = importlib.import_module(f"tools_torch.{name}")
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    buf = io.StringIO()
    try:
        with kernels.recording(first_only=True) as recorded:
            set_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = mod.main(argv)
            torch.cuda.synchronize()
            launches = launch_counts()
            s = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"{tag}   {line}")
    print(f"{tag} {name} {' '.join(argv)} {env or ''}: {s:.2f} s ({card}); launches {launches}",
          flush=True)
    check(rc == 0, f"{tag}: {name} returned {rc}")
    errs = hold(tag, recorded, "the tool's first inputs")
    return text, launches, errs


def last_json(text):
    return json.loads([line for line in text.splitlines() if line.startswith("{")][-1])


BENCH_PRESETS = (  # preset, metric, the kernels its main path must launch
    ("full", "propose_images_per_sec_vgg16_600x800", ("nms", "chain", "strip")),
    ("coco_deep", "propose_images_per_sec_coco_deep_tree", ("nms", "chain", "strip")),
    ("resnet50_1080p", "propose_images_per_sec_resnet50_1080p", ("nms", "frozen_bn")),
)


def phase15b_bench(card):
    """``tools_torch.bench`` in this process at ``full`` (batches 16 and 32),
    ``coco_deep`` and ``resnet50_1080p`` (their default batches): each line's
    metric name, a finite positive value, ``nms_mboxes_per_sec`` on
    ``full``, the kernels of each path launched."""
    out = {}
    for preset, metric, kernels in BENCH_PRESETS:
        text, launches, errs = run_tool(f"phase15b {preset}", "bench", [], card,
                                        {"AZNET_BENCH_PRESET": preset})
        line = last_json(text)
        check(line["metric"] == metric, f"phase15b {preset}: metric {line['metric']}")
        check(np.isfinite(line["value"]) and line["value"] > 0,
              f"phase15b {preset}: value {line['value']}")
        if preset == "full":
            check(list(line["batches"]) == ["16", "32"], f"phase15b full: {line['batches']}")
            rate = line.get("nms_mboxes_per_sec")
            check(rate is not None and np.isfinite(rate) and rate > 0,
                  f"phase15b full: nms_mboxes_per_sec {rate}")
        for k in kernels:
            check(launches[k] > 0, f"phase15b {preset}: the {k} kernel never launched")
        out[preset] = {"line": line, "launches": launches, "errs": errs}
    return out


def phase15cd_tools(card):
    """``tools_torch.bench_nms`` with its four tiers, then every other
    ``tools_torch/bench_*`` at its defaults (``bench_coco_eval --images
    500``; ``bench_fused_detect`` on snapshots of seeded nets), each with its
    launches."""
    import tempfile
    from pathlib import Path

    from aznet_tpu_torch import api
    from aznet_tpu_torch.utils.checkpoint import Checkpointer
    from tools_torch import _common, bench_fused_detect

    out = {}
    text, launches, errs = run_tool("phase15c", "bench_nms", [], card)
    line = last_json(text)
    tiers = {"cuda_n8192", "cuda_n32768", "plain_fixpoint_n4096", "cpp_host_n8192"}
    check(set(line["detail"]) == tiers, f"phase15c: tiers {sorted(line['detail'])}")
    check(all(np.isfinite(v) and v > 0 for v in line["detail"].values()),
          f"phase15c: rates {line['detail']}")
    out["bench_nms"] = {"line": line, "launches": launches, "errs": errs}

    cfg_path = str(Path(__file__).resolve().parent / TOOLS_CFG)
    check((bench_fused_detect.SCORE_TOL, bench_fused_detect.BOX_TOL) == (FUSED_S_TOL, FUSED_B_TOL),
          "phase15d: bench_fused_detect's bounds are not phase 10's")
    # The two full-width snapshots (about a gigabyte) go with the directory.
    with tempfile.TemporaryDirectory(prefix="aznet_fused_detect_") as snaps:
        cfg = _common.load_config(cfg_path)
        for kind, build, seed in (("az", api.build_az_net, None),
                                  ("frcnn", api.build_frcnn_net, 1)):
            net = build(cfg, device="cuda", seed=seed)
            Checkpointer(f"{snaps}/{kind}").save(0, {"params": net.params})
        del net
        runs = (  # tag, tool, argv, the kernels it must launch
            ("phase15d", "bench_trunk", [], ("chain", "strip")),
            ("phase15d", "bench_roi", [], ("roi_align",)),
            ("phase15d", "bench_nms_variants", [], ("nms",)),
            ("phase15d", "bench_fused_detect", ["--cfg", cfg_path, "--ckpt", f"{snaps}/az",
                                                "--frcnn-ckpt", f"{snaps}/frcnn"], ("nms",)),
            ("phase15d", "bench_train", [], ()),
            ("phase15d", "bench_coco_eval", ["--images", "500"], ()),
        )
        for tag, name, argv, kernels in runs:
            text, launches, errs = run_tool(tag, name, argv, card)
            for k in kernels:
                check(launches[k] > 0, f"{tag} {name}: the {k} kernel never launched")
            line = last_json(text)
            if name == "bench_fused_detect":
                # Phase 10's bounds: the two paths pool at boxes one bf16 rounding
                # apart (tests/test_torch_eval.py), so a detection can cross the
                # per-image cap; `identical` (the reference's 1e-3) is reported.
                keys = {"fused_img_per_sec", "unfused_img_per_sec", "speedup", "map_fused",
                        "map_unfused", "identical", "unmatched", "trunks_value_equal"}
                check(keys <= set(line), f"{tag} {name}: keys {sorted(line)}")
                check(line["unmatched"] <= FUSED_MISS,
                      f"{tag} {name}: {line['unmatched']} of the fused and two-program rows "
                      f"unmatched within {FUSED_S_TOL} / {FUSED_B_TOL} px")
            if name == "bench_train":
                check(np.isfinite(line["value"]) and line["value"] > 0
                      and line["mfu_vs_bf16_peak"] > 0, f"{tag} {name}: {line}")
            out[name] = {"line": line, "launches": launches, "errs": errs}
    return out


def phase15e_entry(card):
    """``aznet_tpu_torch.entry``: ``entry()`` on the card (the shapes, finite
    values, live proposals, its NMS launches), then ``dryrun_multichip(1)``
    on NCCL in this process and ``dryrun_multichip(2)`` over gloo ranks."""
    import io

    import torch

    from aznet_tpu_torch import entry as tentry
    from aznet_tpu_torch.ops.cuda import launch_counts, set_launch_counts

    set_launch_counts()
    fn, args = tentry.entry()
    boxes, scores, valid = fn(*args)
    torch.cuda.synchronize()
    launches = launch_counts()
    check(tuple(boxes.shape) == (1, 300, 4) and tuple(scores.shape) == (1, 300)
          and tuple(valid.shape) == (1, 300), f"phase15e entry(): shapes {boxes.shape}")
    check(bool(torch.isfinite(boxes).all()) and bool(torch.isfinite(scores[valid]).all())
          and int(valid.sum()) > 0, "phase15e entry(): non-finite output or no live proposal")
    check(launches["nms"] > 0, "phase15e entry(): the NMS kernel never launched")
    print(f"phase15e entry(): boxes {tuple(boxes.shape)}, {int(valid.sum())} live proposals on "
          f"{args[0].device} ({card}); launches {launches}", flush=True)
    for n in (1, 2):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            tentry.dryrun_multichip(n)
        text = buf.getvalue()
        for line in text.splitlines():
            print(f"phase15e   {line}")
        backend = "nccl" if n == 1 else "gloo"
        for tag in (f"dryrun_multichip({n}): ", f"backend={backend}", "sharded_propose",
                    "latency_propose", "sharded_detect", "dryrun_multihost"):
            check(tag in text, f"phase15e dryrun_multichip({n}): no {tag!r} line")
        print(f"phase15e dryrun_multichip({n}): {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": launches}


def phase15_tools(dev, card):
    """Phase 15: the NMS kernel beyond 8192 boxes and the measurement entry
    points (``tools_torch/bench*.py``, ``aznet_tpu_torch/entry.py``)."""
    t0 = time.perf_counter()
    err, large = phase15a_nms_large(dev)
    out = {"nms_err": err, "nms_large": large, "bench": phase15b_bench(card),
           "tools": phase15cd_tools(card), "entry": phase15e_entry(card)}
    out["path_errs"] = {}
    for r in (*out["bench"].values(), *out["tools"].values()):
        for k, v in r["errs"].items():
            out["path_errs"][k] = max(out["path_errs"].get(k, 0.0), v)
    print(f"phase15 {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    timers = {"--conv-times": conv_times, "--conv1-times": conv1_times,
              "--roi-times": roi_times, "--nms-times": nms_times, "--iou-times": iou_times,
              "--search-level-times": search_level_times,
              "--search-select-times": search_select_times,
              "--frozen-bn-times": frozen_bn_times}
    if argv[:1] and argv[0] in timers:
        root = argv[1] if len(argv) > 1 else "."
        sys.path.insert(0, root)
        torch.cuda.set_device(0)
        timers[argv[0]](torch.device("cuda", 0), root)
        return 0
    from aznet_tpu_torch import _build
    from aznet_tpu_torch.config import Config
    from aznet_tpu_torch.ops.cuda import launch_counts, set_launch_counts

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    print(f"build: {lib_path.relative_to(_build.BUILD_ROOT.parent.parent)} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    print((lib_path.parent / "nvcc.log").read_text().strip(), flush=True)
    if argv[:1] == ["--mesh-phase"]:
        phase13_mesh(dev, card)
        return 0
    if argv[:1] == ["--tools-phase"]:
        phase15_tools(dev, card)
        return 0
    if argv[:1] == ["--settings-phase"]:
        net = build_net("phase2", Config(), dev)
        p2 = phase2_propose(dev, net)
        int8 = phase4_int8(dev, net, p2["blobs"], p2["ips"])
        del net
        phase14_settings(dev, int8)
        return 0

    err1, times = phase1_nms(dev)
    # VGG-16 at full width, bf16 (Config()'s default), default search.
    net = build_net("phase2", Config(), dev)
    p2 = phase2_propose(dev, net)
    phase2_reference(dev)
    precision_probe(dev)
    bf16_reduction_probe(dev)

    conv = phase3_conv(dev)
    int8 = phase4_int8(dev, net, p2["blobs"], p2["ips"])
    phase4_reference(dev)
    del net
    torch.cuda.empty_cache()

    new = phase5_kernels(dev)
    level_alone = phase5_search_level(dev)
    select_alone = phase5_search_select(dev)
    fbn = phase5_frozen_bn(dev)
    det = phase6_detect(dev)
    phase6_reference(dev)

    # The IoU kernel is on no path: its launches outside phase 7 stay 0.
    iou_path_launches = launch_counts()["iou"]
    iou = phase7_iou(dev)
    set_launch_counts({"iou": 0})
    res = phase8_resnet(dev)
    c4 = phase8b_c4_detect(dev)
    fpn = phase8c_fpn_detect(dev)
    small = phase9_small(dev)
    iou_path_launches += launch_counts()["iou"]
    ev = phase10_eval(dev, card)  # sets the IoU count to 0 and reads it with the others
    set_launch_counts({"iou": 0})
    phase10_reference(dev)
    iou_path_launches += ev["launches"]["iou"] + launch_counts()["iou"]
    tr = phase11_train(dev, card)  # sets every count to 0 and reads them at its end
    train = tr["launches"]
    tl = phase12_tools(dev, card)  # the same
    tools = tl["launches"]
    mp = phase13_mesh(dev, card)  # the same, at world size 1 on NCCL
    mesh = mp["launches"]
    last = phase14_settings(dev, int8)  # sets the counts it reads to 0 just before each path
    p15 = phase15_tools(dev, card)  # the same, before each tool
    bench_full = p15["bench"]["full"]["launches"]
    paths = [res["bf16"], res["int8"], small["caffenet"], small["vgg_cnn_m_1024"]]
    print(f"phase7-10 launches: IoU kernel {iou_path_launches} on the main paths (no path calls "
          f"it); " + "; ".join(f"{tag} nms {p['launches']['nms']}, roi_align "
                               f"{p['launches']['roi_align']}" for tag, p in zip(
              ("resnet50 bf16", "resnet50 int8", "caffenet", "vgg_cnn_m_1024"), paths)),
          flush=True)
    # Each kernel's largest error on the paths' own inputs, phases 2, 4, 6 and 8-15.
    path_errs = [p2["err"], int8["err"], det["err"], c4["err"], fpn["err"], ev["err"], tr["err"], tl["err"],
                 mp["err"], p15["path_errs"], *(p["err"] for p in paths),
                 *(last[k]["err"] for k in ("c12", "xla", "conv1_f32"))]

    def path_err(*names):
        return max(e.get(k, 0.0) for e in path_errs for k in names)

    nms_t = times["path_1x2048"]
    nms_b = nms_bound(1, 2048)
    records = [{
        "name": "nms_exact_greedy", "route": "cuda", "source": NMS_SOURCE,
        "replaces": NMS_REPLACES, "launches": p2["launches"]["nms"],
        "eval_launches": ev["launches"]["nms"], "train_launches": train["nms"],
        "tools_launches": tools["nms"], "mesh_launches": mesh["nms"],
        "bench_launches": bench_full["nms"],
        "max_abs_err": max(err1, p15["nms_err"], path_err("nms")),
        "ms": nms_t["ms"], "device_us": nms_t["device_us"], "plain_ms": nms_t["plain_ms"],
        "bound_ms": nms_b[0], "bound_by": nms_b[1], "library_ms": None,
        "large": {name: {k: t[k] for k in ("ms", "device_us", "passes", "plain_ms", "bound_ms",
                                           "bound_by", "held_against")}
                  for name, t in p15["nms_large"].items()}}]
    for entry, replaces in (("chain", CHAIN_REPLACES), ("strip", STRIP_REPLACES)):
        b_ms, b_by = int8_conv_bound(entry)
        records.append({
            "name": f"conv3x3_int8_{entry}", "route": "cuda", "source": CONV_SOURCE,
            "replaces": replaces, "launches": int8["launches"][entry],
            "eval_launches": ev["launches"][entry], "train_launches": train[entry],
            "tools_launches": tools[entry], "mesh_launches": mesh[entry],
            "conv1_2_launches": last["c12"]["launches"][entry],
            "bench_launches": bench_full[entry],
            "max_abs_err": max(conv["err"][entry], path_err(entry)),
            "ms": conv["ms"][entry], "plain_ms": conv["plain_ms"][entry],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": conv["library_ms"][entry],
            "c64": conv["c64"][entry]})
    for key, name, source, replaces in (
            ("roi_align", "roi_align_fused", ROI_SOURCE, ROI_REPLACES),
            ("conv1", "conv1_fused_pool", CONV1_SOURCE, CONV1_REPLACES)):
        rec = new["roi" if key == "roi_align" else key]
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": det["launches"][key], "eval_launches": ev["launches"][key],
            "train_launches": train[key], "tools_launches": tools[key],
            "mesh_launches": mesh[key], "max_abs_err": max(rec["err"], path_err(key)),
            **({"c4_detect_launches": c4["launches"][key]} if key == "roi_align" else {}),
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound"][0],
            "bound_by": rec["bound"][1], "library_ms": rec["library_ms"]})
    rec = last["conv1_f32"]
    records.append({
        "name": "conv1_fused_pool_f32", "route": "cuda", "source": CONV1_F32_SOURCE,
        "replaces": CONV1_REPLACES, "launches": rec["launches"]["conv1_f32"],
        "max_abs_err": path_err("conv1_f32"),
        "float64_err": rec["errs"], "ms": rec["ms"], "device_us": rec["device_us"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound"][0], "bound_by": rec["bound"][1],
        "library_ms": rec["library_ms"]})
    records.append({
        "name": "bbox_overlaps_iou", "route": "cuda", "source": IOU_SOURCE,
        "replaces": IOU_REPLACES, "launches": iou_path_launches,
        "eval_launches": ev["launches"]["iou"], "train_launches": train["iou"],
        "tools_launches": tools["iou"], "mesh_launches": mesh["iou"], "max_abs_err": iou["err"],
        "ms": iou["ms"], "device_us": iou["device_us"], "plain_ms": iou["plain_ms"],
        "bound_ms": iou["bound"][0], "bound_by": iou["bound"][1], "library_ms": None})
    lv, (b_ms, b_by) = level_alone[128], search_level_bound(128, 11, 128)
    records.append({
        "name": "search_level", "route": "cuda", "source": SEARCH_LEVEL_SOURCE,
        "replaces": None, "plain": SEARCH_LEVEL_PLAIN, "launches": p2["launches"]["search_level"],
        "int8_launches": int8["launches"]["search_level"],
        "detect_launches": det["launches"]["search_level"],
        "resnet50_launches": res["bf16"]["launches"]["search_level"],
        "eval_launches": ev["launches"]["search_level"], "train_launches": train["search_level"],
        "tools_launches": tools["search_level"], "mesh_launches": mesh["search_level"],
        "bench_launches": bench_full["search_level"],
        "max_abs_err": path_err("search_seed", "search_level", "search_select"),
        "ms": lv["kernel"]["ms"], "device_us": lv["kernel"]["device_us"],
        "host_us": lv["kernel"]["host_us"], "plain_ms": lv["plain"]["ms"],
        "plain_device_us": lv["plain"]["device_us"], "plain_launches": lv["plain"]["launches"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "r": 128,
        "r64": {k: level_alone[64][name][key] for k, name, key in (
            ("ms", "kernel", "ms"), ("device_us", "kernel", "device_us"),
            ("plain_ms", "plain", "ms"), ("plain_device_us", "plain", "device_us"))}})
    records.append({
        "name": "search_select", "route": "cuda", "source": SEARCH_SELECT_SOURCE,
        "replaces": None, "plain": SEARCH_SELECT_PLAIN,
        "launches": p2["launches"]["search_select"],
        "int8_launches": int8["launches"]["search_select"],
        "detect_launches": det["launches"]["search_select"],
        "resnet50_launches": res["bf16"]["launches"]["search_select"],
        "eval_launches": ev["launches"]["search_select"],
        "train_launches": train["search_select"], "tools_launches": tools["search_select"],
        "mesh_launches": mesh["search_select"], "bench_launches": bench_full["search_select"],
        "max_abs_err": records[-1]["max_abs_err"], "bound_ms": None, "library_ms": None,
        "alone": {config: {f"{part}_{name}": {k: v[k] for k in ("ms", "device_us", "launches",
                                                                  "host_us")}
                           for (part, name), v in t.items()}
                  for config, t in select_alone.items()}})
    fsum = fbn["sum"]
    records.append({
        "name": "frozen_bn", "route": "cuda", "source": FROZEN_BN_SOURCE, "replaces": None,
        "plain": FROZEN_BN_PLAIN, "launches": res["bf16"]["launches"]["frozen_bn"],
        "int8_launches": res["int8"]["launches"]["frozen_bn"],
        "c4_detect_launches": c4["launches"]["frozen_bn"],
        "bench_launches": p15["bench"]["resnet50_1080p"]["launches"]["frozen_bn"],
        "eval_launches": ev["launches"]["frozen_bn"], "train_launches": train["frozen_bn"],
        "tools_launches": tools["frozen_bn"], "mesh_launches": mesh["frozen_bn"],
        "max_abs_err": max(fbn["err"], path_err("frozen_bn")),
        "device_us": fsum["device_us"], "host_us": fsum["host_us"] / 40,
        "host_us_max": fbn["host_us_max"], "plain_device_us": fsum["plain_device_us"],
        "plain_launches": fsum["plain_launches"],
        "bound_ms": fsum["bound_us"] / 1e3, "bound_by": "bytes", "library_ms": None,
        "trunk_ms": fbn["trunk_ms"], "peak_bytes": fbn["peak_bytes"],
        "batch": FROZEN_BN_BATCH, "canvas": RESNET_CANVAS})
    lv = fpn["kernel"]
    records.append({
        "name": "roi_align_levels", "route": "cuda", "source": ROI_SOURCE, "replaces": None,
        "plain": ROI_LEVELS_PLAIN, "launches": fpn["launches"]["roi_align_levels"],
        "eval_launches": ev["launches"]["roi_align_levels"],
        "train_launches": train["roi_align_levels"], "tools_launches": tools["roi_align_levels"],
        "mesh_launches": mesh["roi_align_levels"], "max_abs_err": path_err("roi_align_levels"),
        "ms": lv["ms"], "device_us": lv["device_us"], "host_us": lv["host_us"],
        "plain_ms": lv["plain_ms"], "bound_ms": lv["bound"][0], "bound_by": lv["bound"][1],
        "library_ms": lv["library_ms"], "boxes_a_level": lv["boxes_a_level"],
        "canvas": FPN_CANVAS})
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
