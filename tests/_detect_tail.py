"""What the detect-tail tests share (no JAX: the card's tests import it):

- :func:`per_image_detect`, the batched detect entry in its per-image form:
  after ONE trunk call, each image's head, softmax, decode and clip on its
  own, every clip bound a tensor made on the features' device, and with
  ``TEST.BBOX_ITER`` each image's own passes. The one-pass tail of
  ``api._detect_heads`` has to give its bits.
- :func:`no_syncs_after_the_trunk`, which turns
  ``torch.cuda.set_sync_debug_mode("error")`` on from the trunk's return to
  the entry's return, so that any copy or host read in the tail raises.
"""

import contextlib

import torch

from aznet_tpu_torch import api
from aznet_tpu_torch.ops.boxes import bbox_transform_inv


def _clip_each(pred, h, w, offset):
    """``pred [R, 4K]`` clipped to ``[0, W - offset]`` x ``[0, H - offset]``,
    each bound a tensor on ``pred``'s device."""
    p = pred.reshape(pred.shape[0], -1, 4)
    cols = []
    for j in range(4):
        hi = torch.as_tensor((w if j % 2 == 0 else h) - offset, dtype=pred.dtype,
                             device=pred.device)
        cols.append(torch.minimum(p[..., j].clamp(min=0.0), hi))
    return torch.stack(cols, dim=-1).reshape(pred.shape)


@torch.inference_mode()
def per_image_detect(model, cfg, images, boxes, canvas, src_hw=None, scales=None):
    """``(scores [B, R, K], pred_boxes [B, R, 4K])`` with the head's tail run
    one image at a time."""
    off = cfg.BOX_OFFSET
    preps, blob = api._preprocess(cfg, images, canvas, src_hw, scales)
    feats = api._maybe_quantize_feat(cfg, model.features(blob))
    outs = []
    for i, (feat, (_, im_scale, _)) in enumerate(zip(feats, preps)):
        h, w = ((float(images.shape[1]), float(images.shape[2])) if src_hw is None
                else (src_hw[i, 0], src_hw[i, 1]))
        b, rois = boxes[i], boxes[i] * im_scale
        n_iter = max(int(cfg.TEST.BBOX_ITER), 1)
        for it in range(n_iter):
            out = model.roi_forward(feat, rois)
            scores = torch.softmax(out["cls_score"], dim=-1)
            pred = _clip_each(bbox_transform_inv(b, out["bbox_pred"], off), h, w, off)
            if it + 1 < n_iter:
                cls = scores[:, 1:].argmax(dim=1) + 1
                rows = torch.arange(pred.shape[0], device=pred.device)
                b = pred.reshape(pred.shape[0], -1, 4)[rows, cls]
                rois = b * im_scale
        outs.append((scores, pred))
    return tuple(torch.stack(t) for t in zip(*outs))


@contextlib.contextmanager
def no_syncs_after_the_trunk(model):
    """Inside the block, every call of ``model.features`` leaves the sync
    debug mode at ``"error"`` until the block ends."""
    features = model.features

    def features_then_error(blob):
        out = features(blob)
        torch.cuda.set_sync_debug_mode("error")
        return out

    model.features = features_then_error
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
        del model.features
