"""Propose-side public API (counterpart of ``aznet_tpu/api/__init__.py``).

- :func:`build_az_net` -> :class:`Net` (model, config, device);
- :func:`im_propose` (one raw BGR image -> float32 ``(N, 5)`` proposals in
  original coordinates, as the reference);
- :func:`make_propose_batch` / :func:`make_propose_batch_padded`, the
  batched path: the trunk runs once on the whole batch, then the search
  runs per image.

Everything runs eagerly on ``Net.device``; there is no compile cache.

Int8 (``COMPUTE_DTYPE='int8'``, scales from ``ops/quant.py``): the trunk
keeps float32 parameters and quantizes its int8 layers once at build time;
the heads are cast to bf16 and, with ``INT8_HEAD_SCALES``, quantized once
from those bf16-rounded weights; ``INT8_ROI`` quantizes the trunk's output
once per image so that ROI align and fc6 run on int8.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aznet_tpu.config import Config
from aznet_tpu_torch.models.aznet import AZNet, init_params
from aznet_tpu_torch.ops.conv_int8 import quantize_acts
from aznet_tpu_torch.ops.nms import nms_topk
from aznet_tpu_torch.ops.preprocess import compute_scale, preprocess_image
from aznet_tpu_torch.search.propose import az_search


@dataclasses.dataclass
class Net:
    """Model (weights included) + config + device. ``params`` is the float32
    state dict the net was built from, on the host, as the reference's
    ``Net.params`` is its float32 tree: the model's own weights may be cast
    or quantized, and a net rebuilt from ``params`` starts from float32."""

    model: AZNet
    cfg: Config
    device: torch.device
    params: dict


def _cast_inference_params(model: AZNet, cfg: Config) -> AZNet:
    """Cast ONCE (the reference casts per call; the port keeps the cast
    weights). bf16 mode: every float parameter to bf16. int8 mode: everything
    but the trunk, whose int8 layers quantize float32 weights. The fused head
    dot then runs in f32 on the bf16-rounded weights, as the reference's."""
    if cfg.MODEL.COMPUTE_DTYPE == "bfloat16":
        model.to(torch.bfloat16)
    elif cfg.MODEL.COMPUTE_DTYPE == "int8":
        for name, child in model.named_children():
            if name != "trunk":
                child.to(torch.bfloat16)
    return model


def build_az_net(cfg: Config, state_dict: dict | None = None, device="cpu",
                 seed: int | None = None) -> Net:
    """An AZ-Net on ``device``: weights from ``state_dict`` (e.g.
    :func:`aznet_tpu_torch.utils.convert.params_from_flax`), else a seeded
    init (``seed``, default ``cfg.RNG_SEED``). Weights are not the JAX
    package's init for the same seed: torch and JAX draw differently."""
    device = torch.device(device)
    with torch.device("meta"):
        model = AZNet(cfg.MODEL)
    model = model.to_empty(device=device)
    if state_dict is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(cfg.RNG_SEED if seed is None else seed)
        init_params(model, gen)
    else:
        model.load_state_dict(state_dict)
    model.eval()
    params = {k: v.detach().to("cpu", torch.float32, copy=True)
              for k, v in model.state_dict().items()}
    model = _cast_inference_params(model, cfg)
    model.prepare_int8()
    return Net(model, cfg, device, params)


def _canvas_for(h: int, w: int, cfg: Config, bucket: int = 64):
    """Static canvas for an ``h x w`` image: its scaled size rounded up to
    ``bucket``."""
    scale = compute_scale(h, w, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE)
    sh, sw = int(round(h * scale)), int(round(w * scale))
    rup = lambda v: int(-(-v // bucket) * bucket)
    return rup(sh), rup(sw)


def _blob_dtype(cfg: Config):
    """float32 in float32 mode, else bf16 (int8 mode's prefix runs in bf16)."""
    return torch.float32 if cfg.MODEL.COMPUTE_DTYPE == "float32" else torch.bfloat16


def _maybe_quantize_feat(cfg: Config, feat: torch.Tensor) -> torch.Tensor:
    """``MODEL.INT8_ROI``: quantize the trunk output once, at conv5_3's
    calibrated scale (``INT8_HEAD_SCALES[0]``), so that ROI align and fc6 run
    on int8 at every level of the search."""
    mc = cfg.MODEL
    if (mc.INT8_ROI and mc.INT8_HEAD_SCALES and mc.POOLING_MODE == "align"
            and mc.COMPUTE_DTYPE != "float32"):
        return quantize_acts(feat, mc.INT8_HEAD_SCALES[0])
    return feat


def _propose_images(model: AZNet, cfg: Config, images, canvas_hw, src_hw=None, scales=None):
    """Raw ``images [B, H, W, 3]`` -> ``(boxes [B, N, 4], scores, valid)`` in
    original coordinates: preprocess each image, ONE trunk call on the batch,
    then the search per image."""
    preps = [preprocess_image(
        images[i], cfg.PIXEL_MEANS, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE,
        canvas_hw[0], canvas_hw[1], dtype=_blob_dtype(cfg),
        src_hw=None if src_hw is None else src_hw[i],
        scale=None if scales is None else scales[i]) for i in range(images.shape[0])]
    feats = _maybe_quantize_feat(cfg, model.features(torch.stack([p[0] for p in preps])))
    outs = []
    for feat, (_, im_scale, valid_hw) in zip(feats, preps):
        boxes, scores, valid = az_search(
            model.roi_forward, feat, valid_hw, cfg.SEAR,
            num_templates=cfg.MODEL.NUM_TEMPLATES, offset=cfg.BOX_OFFSET)
        outs.append((boxes / im_scale, scores, valid))
    return tuple(torch.stack(t) for t in zip(*outs))


def _propose_core(model: AZNet, cfg: Config, image, canvas_hw, src_hw=None, scale=None):
    """One raw ``[H, W, 3]`` image -> ``(boxes, scores, valid)``."""
    out = _propose_images(model, cfg, image[None], canvas_hw,
                          None if src_hw is None else [src_hw],
                          None if scale is None else [scale])
    return tuple(t[0] for t in out)


def _scale_cfg(cfg: Config, target: int) -> Config:
    return dataclasses.replace(cfg, TEST=dataclasses.replace(cfg.TEST, SCALES=(target,)))


def _propose_core_pyramid(model: AZNet, cfg: Config, image, canvases):
    """Multi-scale search: the full search per TEST.SCALES entry, merged by
    one cross-scale NMS."""
    runs = [_propose_core(model, _scale_cfg(cfg, t), image, canvases[i])
            for i, t in enumerate(cfg.TEST.SCALES)]
    boxes, scores, valid = (torch.cat(t) for t in zip(*runs))
    return nms_topk(boxes, torch.where(valid, scores, float("-inf")),
                    cfg.SEAR.NMS_THRESH, cfg.SEAR.NUM_PROPOSALS,
                    valid=valid, offset=cfg.BOX_OFFSET)


@torch.inference_mode()
def im_propose(net: Net, im: np.ndarray) -> np.ndarray:
    """Scored proposals ``float32 (N, 5) [x1, y1, x2, y2, score]`` for one raw
    BGR image, in its original coordinates."""
    cfg = net.cfg
    image = torch.from_numpy(np.ascontiguousarray(im)).to(net.device)
    if len(cfg.TEST.SCALES) > 1:
        canvases = tuple(_canvas_for(im.shape[0], im.shape[1], _scale_cfg(cfg, t))
                         for t in cfg.TEST.SCALES)
        boxes, scores, valid = _propose_core_pyramid(net.model, cfg, image, canvases)
    else:
        canvas = _canvas_for(im.shape[0], im.shape[1], cfg)
        boxes, scores, valid = _propose_core(net.model, cfg, image, canvas)
    n = int(valid.sum())
    return torch.cat([boxes[:n], scores[:n, None]], dim=1).float().cpu().numpy()


def make_propose_batch(model: AZNet, cfg: Config, canvas_hw):
    """``fn(images [B, H, W, 3] raw BGR) -> (boxes [B, N, 4], scores [B, N],
    valid [B, N])`` over a fixed canvas; boxes in original coordinates."""

    @torch.inference_mode()
    def fn(images):
        return _propose_images(model, cfg, images, canvas_hw)

    return fn


def make_propose_batch_padded(model: AZNet, cfg: Config, canvas_hw):
    """Batched propose over zero-padded raw images: ``fn(images [B, Hp, Wp,
    3], src_hw [B, 2] float32, scales [B] float32) -> (boxes, scores, valid)``."""

    @torch.inference_mode()
    def fn(images, src_hw, scales):
        return _propose_images(model, cfg, images, canvas_hw, src_hw, scales)

    return fn
