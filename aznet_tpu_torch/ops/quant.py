"""Post-training int8 calibration of the VGG-16 and ResNet-50 trunks and
the fc stack (``aznet_tpu/ops/quant.py``: ``calibrate_trunk_int8``,
``calibrate_trunk_int8_resnet``, ``calibrate_head_int8``,
``calibrate_net_on_imdb``, ``with_int8_scales``).

The float (bf16/f32) net runs on calibration images; forward hooks read each
trunk conv's pre-ReLU output and fc6's, and each scale is the post-ReLU
absolute maximum over 127 (or a percentile of it). The scales are model
configuration, not weights:

    scales = calibrate_trunk_int8(net, images)
    head_scales = calibrate_head_int8(net, images, scales)
    net8 = build_az_net(with_int8_scales(net.cfg, scales, head_scales),
                        state_dict=net.params, device=net.device)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from aznet_tpu_torch import api
from aznet_tpu_torch.config import Config
from aznet_tpu_torch.models.aznet import AZNet
from aznet_tpu_torch.models.vgg import VGG16_LAYOUT
from aznet_tpu_torch.ops.preprocess import im_list_to_blob, prep_im_for_blob
from aznet_tpu_torch.search.templates import division_tree_regions

CONV_NAMES = tuple(n for n, ch in VGG16_LAYOUT if ch is not None)


def _capture(modules: dict, reduce, use_input: bool = False):
    """Forward hooks that store ``reduce(output)`` (``reduce(first input)``
    with ``use_input``) per name; returns (results dict, hook handles)."""
    seen, handles = {}, []
    for name, mod in modules.items():
        def hook(_mod, inp, out, name=name):
            seen.setdefault(name, []).append(reduce(inp[0] if use_input else out))
        handles.append(mod.register_forward_hook(hook))
    return seen, handles


def _relu_max(out: torch.Tensor) -> float:
    return float(torch.relu(out.float()).max())


@torch.inference_mode()
def calibrate_trunk_int8(net, images, percentile: float = 100.0,
                         batch_size: int = 4) -> tuple:
    """Per-layer activation scales of a bf16/f32 vgg16 ``Net`` from
    ``images [N, H, W, 3]`` (preprocessed BGR, mean-subtracted): a tuple of
    13 floats, conv1_1 .. conv5_3 (conv5_3's is kept for the head's
    ``s_in``; the trunk never requantizes its output)."""
    if net.cfg.MODEL.COMPUTE_DTYPE == "int8":
        raise ValueError("calibrate with a bfloat16/float32 net, not int8")
    trunk = net.model.trunk
    reduce = (_relu_max if percentile >= 100.0 else
              lambda out: float(np.percentile(torch.relu(out.float()).cpu().numpy(), percentile)))
    seen, handles = _capture({n: getattr(trunk, n) for n in CONV_NAMES}, reduce)
    try:
        images = np.asarray(images, np.float32)
        for start in range(0, images.shape[0], batch_size):
            net.model.features(torch.from_numpy(images[start:start + batch_size]).to(net.device))
    finally:
        for h in handles:
            h.remove()
    return tuple(max(max(seen[n]), 1e-6) / 127.0 for n in CONV_NAMES)


@torch.inference_mode()
def calibrate_trunk_int8_resnet(net, images, batch_size: int = 2) -> tuple:
    """Activation scales of the int8 ResNet-50 bottleneck 1x1 convs from a
    bf16/f32 resnet50 ``Net`` on ``images [N, H, W, 3]`` (preprocessed):
    per block, in block order, the block input's (conv1 and the downsample)
    and the post-bn2-ReLU mid activation's (conv3) absolute maximum over
    127, then a trailing trunk-output scale, which the trunk does not use
    and :func:`calibrate_head_int8` reads as ``trunk_scales[-1]``."""
    if net.cfg.MODEL.COMPUTE_DTYPE == "int8":
        raise ValueError("calibrate with a bfloat16/float32 net, not int8")
    trunk = net.model.trunk
    blocks = dict(zip(trunk.block_names, trunk.blocks()))
    absmax = lambda t: float(t.float().abs().max())
    # Each block's input, bn2's output before its ReLU, the trunk's output.
    seen_in, h_in = _capture(blocks, absmax, use_input=True)
    seen_mid, h_mid = _capture({n: b.bn2 for n, b in blocks.items()}, _relu_max)
    seen_out, h_out = _capture({"out": trunk}, absmax)
    try:
        images = np.asarray(images, np.float32)
        for start in range(0, images.shape[0], batch_size):
            net.model.features(torch.from_numpy(images[start:start + batch_size]).to(net.device))
    finally:
        for h in h_in + h_mid + h_out:
            h.remove()
    per_block = [max(max(seen[n]), 1e-6) / 127.0
                 for n in trunk.block_names for seen in (seen_in, seen_mid)]
    return tuple(per_block + [max(max(seen_out["out"]), 1e-6) / 127.0])


@torch.inference_mode()
def calibrate_head_int8(net, images, trunk_scales, batch_size: int = 2):
    """``(s_in, s_mid)`` for the int8 fc6/fc7 stack: ``s_in`` is the trunk
    output's scale (ROI align is a convex combination, so pooled features
    share its range); ``s_mid`` is fc6's post-ReLU absolute maximum over 127,
    over the level-0..2 division-tree regions of each calibration image."""
    images = np.asarray(images, np.float32)
    h, w = images.shape[1:3]
    rois = torch.from_numpy(division_tree_regions((h, w), 2, offset=net.cfg.BOX_OFFSET))
    rois = rois.to(net.device)
    if net.model.head.fc.int8_scales:
        raise ValueError("calibrate the head with a net whose fc stack is float")
    seen, handles = _capture({"fc6": net.model.head.fc.fc6}, _relu_max)
    try:
        for start in range(0, images.shape[0], batch_size):
            feats = net.model.features(
                torch.from_numpy(images[start:start + batch_size]).to(net.device))
            for feat in feats:
                net.model.roi_forward(feat, rois)
    finally:
        for hd in handles:
            hd.remove()
    return (float(trunk_scales[-1]), max(max(seen["fc6"]), 1e-6) / 127.0)


def calibrate_net_on_imdb(net, imdb, n_images: int = 8, percentile: float = 100.0,
                          int8_heads: bool = True):
    """Calibrate a bf16/f32 vgg16 ``net`` on the first ``n_images`` images of
    ``imdb`` (TEST-scale blobs from ``ops.preprocess.prep_im_for_blob``,
    zero-padded to one batch) and return the int8 net, rebuilt with the
    scale-carrying config from the SAME float32 ``net.params`` on
    ``net.device``. ``int8_heads`` also quantizes the fc6/fc7 stack."""
    cfg = net.cfg
    if cfg.MODEL.BACKBONE != "vgg16":
        raise ValueError("int8 calibration supports the vgg16 trunk only")
    ims = []
    for i in range(min(n_images, imdb.num_images)):
        im = imdb.image_array(imdb.roidb[i])
        blob, _ = prep_im_for_blob(im, cfg.PIXEL_MEANS, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE)
        ims.append(blob)
    images = im_list_to_blob(ims)
    scales = calibrate_trunk_int8(net, images, percentile=percentile, batch_size=2)
    head_scales = calibrate_head_int8(net, images, scales) if int8_heads else ()
    builder = api.build_az_net if isinstance(net.model, AZNet) else api.build_frcnn_net
    return builder(with_int8_scales(cfg, scales, head_scales), state_dict=net.params,
                   device=net.device)


def with_int8_scales(cfg: Config, scales: Sequence[float],
                     head_scales: Sequence[float] = ()) -> Config:
    """``cfg`` with ``COMPUTE_DTYPE='int8'`` and the given trunk (+head) scales."""
    model = dataclasses.replace(
        cfg.MODEL, COMPUTE_DTYPE="int8",
        INT8_SCALES=tuple(float(s) for s in scales),
        INT8_HEAD_SCALES=tuple(float(s) for s in head_scales))
    return dataclasses.replace(cfg, MODEL=model)
