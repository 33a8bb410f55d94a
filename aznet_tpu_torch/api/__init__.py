"""Public inference API (counterpart of ``aznet_tpu/api/__init__.py``).

Propose side:

- :func:`build_az_net` -> :class:`Net` (model, config, device, params);
- :func:`im_propose` (one raw BGR image -> float32 ``(N, 5)`` proposals in
  original coordinates, as the reference);
- :func:`make_propose_batch` / :func:`make_propose_batch_padded`, the
  batched path: the trunk runs once on the whole batch, then the search
  runs per image.

Detect side:

- :func:`build_frcnn_net`; :func:`im_detect` (one raw image and its boxes ->
  ``(scores (R, K), pred_boxes (R, 4K))``, the image pyramid when
  ``TEST.SCALES`` has several entries); :func:`make_detect_batch` /
  :func:`make_detect_batch_padded`;
- :func:`share_trunk` / :func:`trunks_shared` and
  :func:`make_fused_detect_batch_padded`: one trunk call, the AZ search, and
  the Fast R-CNN head on the search's boxes.

Nets are built on the card (``device="cuda"``) unless ``device="cpu"`` is
passed; without a card that default raises. Everything runs eagerly on
``Net.device``; there is no compile cache.

Each entry call records its spans (``utils/profiling.py``) while a
``torch.profiler`` session runs: a root (``propose``, ``detect``,
``fused_detect``, ``im_propose``, ``im_detect``) with ``upload``,
``preprocess``, ``trunk``, ``search``, ``heads`` and ``download`` under it.

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

from aznet_tpu_torch.config import Config
from aznet_tpu_torch.models.aznet import AZNet, RoiNet, init_params
from aznet_tpu_torch.models.frcnn import FRCNN
from aznet_tpu_torch.ops.boxes import bbox_transform_inv, box_wh, clip_boxes
from aznet_tpu_torch.ops.conv_int8 import quantize_acts
from aznet_tpu_torch.ops.nms import nms_topk
from aznet_tpu_torch.ops.preprocess import compute_scale, preprocess_image
from aznet_tpu_torch.search.propose import az_search
from aznet_tpu_torch.utils import profiling


@dataclasses.dataclass
class Net:
    """Model (weights included) + config + device. ``params`` is the float32
    state dict the net was built from, on the host, as the reference's
    ``Net.params`` is its float32 tree: the model's own weights may be cast
    or quantized, and a net rebuilt from ``params`` starts from float32."""

    model: RoiNet
    cfg: Config
    device: torch.device
    params: dict


def _cast_inference_params(model: RoiNet, cfg: Config) -> RoiNet:
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


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by default; "
                           "pass device='cpu' to run on the CPU")
    return device


def new_model(model_cls, cfg: Config, device, state_dict=None, seed=None) -> RoiNet:
    """A float32 ``model_cls`` on ``device`` (no checks of ``device``):
    weights from ``state_dict``, else the seeded init (``seed``, default
    ``cfg.RNG_SEED``)."""
    with torch.device("meta"):
        model = model_cls(cfg.MODEL)
    model = model.to_empty(device=device)
    if state_dict is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(cfg.RNG_SEED if seed is None else seed)
        init_params(model, gen)
    else:
        model.load_state_dict(state_dict)
    return model


def inference_model(model: RoiNet, cfg: Config) -> RoiNet:
    """``model`` made an inference net in place: eval mode, no gradients, its
    weights cast as :func:`_cast_inference_params` casts them, int8 layers
    quantized."""
    model.eval().requires_grad_(False)
    model = _cast_inference_params(model, cfg)
    model.prepare_int8()
    return model


def _build_net(model_cls, cfg: Config, state_dict, device, seed) -> Net:
    device = _device(device)
    model = new_model(model_cls, cfg, device, state_dict, seed)
    params = {k: v.detach().to("cpu", torch.float32, copy=True)
              for k, v in model.state_dict().items()}
    return Net(inference_model(model, cfg), cfg, device, params)


def build_az_net(cfg: Config, state_dict: dict | None = None, device="cuda",
                 seed: int | None = None) -> Net:
    """An AZ-Net on ``device``: weights from ``state_dict`` (e.g.
    :func:`aznet_tpu_torch.utils.convert.params_from_flax`), else a seeded
    init (``seed``, default ``cfg.RNG_SEED``). Weights are not the JAX
    package's init for the same seed: torch and JAX draw differently."""
    return _build_net(AZNet, cfg, state_dict, device, seed)


def build_frcnn_net(cfg: Config, state_dict: dict | None = None, device="cuda",
                    seed: int | None = None) -> Net:
    """A Fast R-CNN detector on ``device``, as :func:`build_az_net`."""
    return _build_net(FRCNN, cfg, state_dict, device, seed)


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


def _preprocess(cfg: Config, images, canvas_hw, src_hw=None, scales=None):
    """Each raw image of ``images [B, H, W, 3]`` onto the canvas, in a
    ``preprocess`` span: ``(preps, blob)``, ``preps`` a list of ``(blob,
    im_scale, valid_hw)`` and ``blob`` their blobs stacked ``[B, h, w, 3]``."""
    with profiling.span("preprocess"):
        preps = [preprocess_image(
            images[i], cfg.PIXEL_MEANS, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE,
            canvas_hw[0], canvas_hw[1], dtype=_blob_dtype(cfg),
            src_hw=None if src_hw is None else src_hw[i],
            scale=None if scales is None else scales[i]) for i in range(images.shape[0])]
        return preps, torch.stack([p[0] for p in preps])


def _propose_images(model: AZNet, cfg: Config, images, canvas_hw, src_hw=None, scales=None,
                    roi_wrap=None):
    """Raw ``images [B, H, W, 3]`` -> ``(boxes [B, N, 4], scores, valid)`` in
    original coordinates: preprocess each image, ONE trunk call on the batch,
    then the search per image. ``roi_wrap``: a decorator of the search's
    per-level ``roi_forward(feat, rois)`` (the region-parallel path,
    ``parallel/inference.py::region_roi_wrap``)."""
    with profiling.span("propose"):
        preps, blob = _preprocess(cfg, images, canvas_hw, src_hw, scales)
        with profiling.span("trunk"):
            feats = _maybe_quantize_feat(cfg, model.features(blob))
        # Looked up at call time: a caller may replace it on the instance.
        roi_forward = model.roi_forward if roi_wrap is None else roi_wrap(model.roi_forward)
        outs = []
        for i, (feat, (_, im_scale, valid_hw)) in enumerate(zip(feats, preps)):
            with profiling.span("search", image=i):
                boxes, scores, valid = az_search(
                    roi_forward, feat, valid_hw, cfg.SEAR,
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
    with profiling.span("im_propose"):
        with profiling.span("upload"):
            image = torch.from_numpy(np.ascontiguousarray(im)).to(net.device)
        if len(cfg.TEST.SCALES) > 1:
            canvases = tuple(_canvas_for(im.shape[0], im.shape[1], _scale_cfg(cfg, t))
                             for t in cfg.TEST.SCALES)
            boxes, scores, valid = _propose_core_pyramid(net.model, cfg, image, canvases)
        else:
            canvas = _canvas_for(im.shape[0], im.shape[1], cfg)
            boxes, scores, valid = _propose_core(net.model, cfg, image, canvas)
        with profiling.span("download"):
            n = int(valid.sum())
            return torch.cat([boxes[:n], scores[:n, None]], dim=1).float().cpu().numpy()


def make_propose_batch(model: AZNet, cfg: Config, canvas_hw, roi_wrap=None):
    """``fn(images [B, H, W, 3] raw BGR) -> (boxes [B, N, 4], scores [B, N],
    valid [B, N])`` over a fixed canvas; boxes in original coordinates.
    ``roi_wrap`` wraps the search's per-level head call (the region-parallel
    path of ``parallel/inference.py``)."""

    @torch.inference_mode()
    def fn(images):
        return _propose_images(model, cfg, images, canvas_hw, roi_wrap=roi_wrap)

    return fn


def make_propose_batch_padded(model: AZNet, cfg: Config, canvas_hw):
    """Batched propose over zero-padded raw images: ``fn(images [B, Hp, Wp,
    3], src_hw [B, 2] float32, scales [B] float32) -> (boxes, scores, valid)``."""

    @torch.inference_mode()
    def fn(images, src_hw, scales):
        return _propose_images(model, cfg, images, canvas_hw, src_hw, scales)

    return fn


def share_trunk(dst_net: Net, src_net: Net) -> Net:
    """Make ``dst_net`` hold ``src_net``'s trunk, in place: the same module
    (so the same parameter tensors) and the same ``Net.params`` trunk
    entries. The paper's shared-trunk evaluation: AZ-Net and Fast R-CNN on
    one feature map. The trunks must have the same parameter names and
    shapes; ``dst_net`` then runs ``src_net``'s trunk as it is (its dtype,
    int8 weights and ``FUSE_CONV1``). Returns ``dst_net``."""
    src, dst = src_net.model.trunk.state_dict(), dst_net.model.trunk.state_dict()
    if {k: v.shape for k, v in src.items()} != {k: v.shape for k, v in dst.items()}:
        raise ValueError("share_trunk needs trunks with the same parameter names and shapes")
    dst_net.model.trunk = src_net.model.trunk
    dst_net.params = {**dst_net.params, **{k: v for k, v in src_net.params.items()
                                           if k.startswith("trunk.")}}
    return dst_net


def trunks_shared(az_net: Net, frcnn_net: Net) -> bool:
    """True iff the two nets hold the same trunk (:func:`share_trunk`): the
    same parameter objects in the models and in ``Net.params``. Only then is
    the fused program of :func:`make_fused_detect_batch_padded` the same
    function as proposing and detecting with the two nets apart."""
    ta, tb = list(az_net.model.trunk.parameters()), list(frcnn_net.model.trunk.parameters())
    pa = [v for k, v in sorted(az_net.params.items()) if k.startswith("trunk.")]
    pb = [v for k, v in sorted(frcnn_net.params.items()) if k.startswith("trunk.")]
    return (len(ta) == len(tb) and all(a is b for a, b in zip(ta, tb))
            and len(pa) == len(pb) and all(a is b for a, b in zip(pa, pb)))


def select_class_boxes(scores: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Each roi's decoded box of its best FOREGROUND class: ``scores [R, K]``,
    ``pred [R, 4K]`` -> ``[R, 4]``. Class 0 (background) is excluded; ties go
    to the lower class index."""
    cls = scores[:, 1:].argmax(dim=1) + 1
    return pred.reshape(pred.shape[0], -1, 4)[torch.arange(pred.shape[0], device=pred.device), cls]


def _detect_rois(model: FRCNN, cfg: Config, feat, boxes, rois, im_scale, raw_hw):
    """The detection head over one image's features. ``boxes [R, 4]`` in
    original coordinates, ``rois`` the same boxes on the scaled image.
    ``TEST.BBOX_ITER`` passes: each decodes against the original-coordinate
    boxes and clips to the raw image ``raw_hw``; a further pass re-pools
    every roi at its best foreground class's box. Returns ``(softmax scores
    [R, K], pred_boxes [R, 4K])``."""
    off = cfg.BOX_OFFSET
    n_iter = max(int(cfg.TEST.BBOX_ITER), 1)
    for it in range(n_iter):
        out = model.roi_forward(feat, rois)
        scores = torch.softmax(out["cls_score"], dim=-1)
        pred = clip_boxes(bbox_transform_inv(boxes, out["bbox_pred"], off), raw_hw, off)
        if it + 1 < n_iter:
            boxes = select_class_boxes(scores, pred)
            rois = boxes * im_scale
    return scores, pred


def _detect_images(model: FRCNN, cfg: Config, images, boxes, canvas_hw, src_hw=None,
                   scales=None):
    """Raw ``images [B, H, W, 3]`` and ``boxes [B, R, 4]`` (original
    coordinates) -> ``(scores [B, R, K], pred_boxes [B, R, 4K])``: ONE trunk
    call on the batch, then the head per image."""
    with profiling.span("detect"):
        preps, blob = _preprocess(cfg, images, canvas_hw, src_hw, scales)
        with profiling.span("trunk"):
            feats = _maybe_quantize_feat(cfg, model.features(blob))
        outs = []
        for i, (feat, (_, im_scale, _)) in enumerate(zip(feats, preps)):
            raw_hw = ((float(images.shape[1]), float(images.shape[2])) if src_hw is None
                      else src_hw[i])
            with profiling.span("heads", image=i):
                outs.append(_detect_rois(model, cfg, feat, boxes[i], boxes[i] * im_scale,
                                         im_scale, raw_hw))
        return tuple(torch.stack(t) for t in zip(*outs))


def _detect_core_pyramid(model: FRCNN, cfg: Config, image, boxes, canvases):
    """Image-pyramid detection (several ``TEST.SCALES``): the trunk per scale,
    each roi pooled from every scale and assigned to the scale whose scaled
    area is closest to 224**2 (``argmin |area * s**2 - 224**2|``, ties to the
    first scale), then the head ONCE on the selected pooled features."""
    off = cfg.BOX_OFFSET
    w, h = box_wh(boxes, off)
    areas = w * h
    pooled_s, errs = [], []
    for target, canvas in zip(cfg.TEST.SCALES, canvases):
        blob, im_scale, _ = preprocess_image(
            image, cfg.PIXEL_MEANS, target, cfg.TEST.MAX_SIZE, canvas[0], canvas[1],
            dtype=_blob_dtype(cfg))
        feat = _maybe_quantize_feat(cfg, model.features(blob[None]))[0]
        pooled_s.append(model.roi_pool_only(feat, boxes * im_scale))
        errs.append((areas * im_scale ** 2 - 224.0 ** 2).abs())
    assign = torch.stack(errs).argmin(dim=0)
    pooled = torch.stack(pooled_s)[assign, torch.arange(boxes.shape[0], device=boxes.device)]
    out = model.head_forward(pooled)
    scores = torch.softmax(out["cls_score"], dim=-1)
    pred = bbox_transform_inv(boxes, out["bbox_pred"], off)
    return scores, clip_boxes(pred, (float(image.shape[0]), float(image.shape[1])), off)


@torch.inference_mode()
def im_detect(net: Net, im: np.ndarray, boxes: np.ndarray):
    """Detection head forward for one raw BGR image and its boxes (``[R, 4]``
    or ``[R, 5]``, original coordinates): ``(scores (R, K), pred_boxes (R,
    4K))`` float32 NumPy. Several ``TEST.SCALES`` run the image pyramid.
    Rows are independent, so no padding of R is needed."""
    cfg = net.cfg
    with profiling.span("im_detect"):
        with profiling.span("upload"):
            image = torch.from_numpy(np.ascontiguousarray(im)).to(net.device)
            rois = torch.from_numpy(np.ascontiguousarray(boxes[:, :4], dtype=np.float32)).to(
                net.device)
        if len(cfg.TEST.SCALES) > 1:
            canvases = tuple(_canvas_for(im.shape[0], im.shape[1], _scale_cfg(cfg, t))
                             for t in cfg.TEST.SCALES)
            scores, pred = _detect_core_pyramid(net.model, cfg, image, rois, canvases)
        else:
            canvas = _canvas_for(im.shape[0], im.shape[1], cfg)
            scores, pred = (t[0] for t in _detect_images(net.model, cfg, image[None],
                                                         rois[None], canvas))
        with profiling.span("download"):
            return scores.float().cpu().numpy(), pred.float().cpu().numpy()


def make_detect_batch(model: FRCNN, cfg: Config, canvas_hw):
    """``fn(images [B, H, W, 3] raw BGR, boxes [B, R, 4]) -> (scores [B, R,
    K], pred_boxes [B, R, 4K])`` over a fixed canvas."""

    @torch.inference_mode()
    def fn(images, boxes):
        return _detect_images(model, cfg, images, boxes, canvas_hw)

    return fn


def make_detect_batch_padded(model: FRCNN, cfg: Config, canvas_hw):
    """Batched detect over zero-padded raw images: ``fn(images [B, Hp, Wp,
    3], src_hw [B, 2] float32, scales [B] float32, boxes [B, R, 4]) ->
    (scores, pred_boxes)``; boxes clip to each image's true extent."""

    @torch.inference_mode()
    def fn(images, src_hw, scales, boxes):
        return _detect_images(model, cfg, images, boxes, canvas_hw, src_hw, scales)

    return fn


def make_fused_detect_batch_padded(az_model: AZNet, frcnn_model: FRCNN, cfg_az: Config,
                                   cfg_fr: Config, canvas_hw):
    """The shared-trunk pipeline: the trunk ONCE on the batch, the AZ search
    per image, then the Fast R-CNN head on the search's boxes (its rois are
    the search's scaled-image boxes as they are). ``fn(images [B, Hp, Wp,
    3], src_hw [B, 2], scales [B]) -> (prop_boxes [B, N, 4] original
    coordinates, prop_scores [B, N], prop_valid [B, N], det_scores [B, N, K],
    det_boxes [B, N, 4K])``. The trunk is ``az_model``'s; the result is the
    two nets' apart only when :func:`trunks_shared` holds."""

    @torch.inference_mode()
    def fn(images, src_hw, scales):
        with profiling.span("fused_detect"):
            preps, blob = _preprocess(cfg_az, images, canvas_hw, src_hw, scales)
            with profiling.span("trunk"):
                feats = az_model.features(blob)
                # Each net quantizes at its own calibrated scale (INT8_ROI).
                feats_az = _maybe_quantize_feat(cfg_az, feats)
                feats_fr = _maybe_quantize_feat(cfg_fr, feats)
            outs = []
            for i, (_, im_scale, valid_hw) in enumerate(preps):
                with profiling.span("search", image=i):
                    boxes, p_scores, valid = az_search(
                        az_model.roi_forward, feats_az[i], valid_hw, cfg_az.SEAR,
                        num_templates=cfg_az.MODEL.NUM_TEMPLATES, offset=cfg_az.BOX_OFFSET)
                    orig = boxes / im_scale
                with profiling.span("heads", image=i):
                    det_scores, det_boxes = _detect_rois(frcnn_model, cfg_fr, feats_fr[i], orig,
                                                         boxes, im_scale, src_hw[i])
                outs.append((orig, p_scores, valid, det_scores, det_boxes))
            return tuple(torch.stack(t) for t in zip(*outs))

    return fn
