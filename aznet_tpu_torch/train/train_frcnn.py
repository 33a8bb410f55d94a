"""Fast R-CNN training step (``aznet_tpu/train/train_frcnn.py``; the
reference's ``lib/fast_rcnn/train.py``): softmax cross-entropy over the
classes and SmoothL1 on the class-indexed box targets with inside weights.

Batch layout (``data/minibatch.py::get_frcnn_minibatch``):
  images        [B, H, W, 3]
  rois          [B, R, 4]     scaled-image coordinates (sampled fg/bg)
  roi_valid     [B, R]
  labels        [B, R]        int class (0 = background)
  bbox_targets  [B, R, 4C]    class-indexed normalized targets
  bbox_inside   [B, R, 4C]    inside weights (1 on the fg class's 4 slots)
"""

from __future__ import annotations

import torch

from aznet_tpu_torch.config import Config
from aznet_tpu_torch.models.aznet import RoiNet
from aznet_tpu_torch.models.frcnn import FRCNN
from aznet_tpu_torch.ops.losses import smooth_l1_loss, softmax_ce_loss
from aznet_tpu_torch.train.train_az import (TrainState, batch_total, head_outputs, make_step,
                                            make_train_state)


def frcnn_loss(model: RoiNet, batch: dict, generator=None, total=None):
    """The Fast R-CNN loss and its metrics ``loss``, ``cls_loss``,
    ``bbox_loss`` and ``acc`` (the share of valid rois whose argmax class is
    the label); ``total`` as in ``train_az.az_loss``."""
    out = head_outputs(model, batch, generator)
    valid = batch["roi_valid"].float()
    cls_loss = softmax_ce_loss(out["cls_score"], batch["labels"], weights=valid, total=total)
    n_rois = torch.clamp(batch_total(total, valid.sum()), min=1.0)
    bbox_loss = smooth_l1_loss(out["bbox_pred"], batch["bbox_targets"],
                               inside_weights=batch["bbox_inside"],
                               outside_weights=valid[..., None]) / n_rois
    loss = cls_loss + bbox_loss
    acc = ((out["cls_score"].argmax(-1) == batch["labels"]) * valid).sum() / n_rois
    return loss, {"loss": loss, "cls_loss": cls_loss, "bbox_loss": bbox_loss, "acc": acc}


def make_frcnn_train_state(cfg: Config, device="cuda", state_dict=None, seed=None,
                           mesh=None) -> TrainState:
    return make_train_state(FRCNN, cfg, device, state_dict, seed, mesh)


def make_frcnn_train_step(model: RoiNet, mesh=None):
    """The Fast R-CNN step (``train_az.make_step`` over :func:`frcnn_loss`)."""
    return make_step(model, frcnn_loss, mesh)
