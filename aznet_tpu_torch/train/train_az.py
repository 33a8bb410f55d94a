"""AZ-Net training step (``aznet_tpu/train/train_az.py``; the reference's
``lib/detect/train.py``): sigmoid cross-entropy for the zoom indicator and
the adjacency confidences, SmoothL1 with inside weights for the adjacency
deltas, one SGD update.

Batch layout (``data/minibatch.py``; NumPy or tensors):
  images       [B, H, W, 3]   preprocessed (scaled, mean-subtracted BGR)
  rois         [B, R, 4]      anchor regions, scaled-image coordinates
  roi_valid    [B, R]         padding mask
  zoom_labels  [B, R]         {0, 1}
  adj_labels   [B, R, K]      {0, 1}
  adj_targets  [B, R, K, 4]   normalized regression targets
  adj_inside   [B, R, K, 4]   inside weights (1 on matched templates)

The trunk runs once on the batch; the rois of all images go through the
head as one ``[B * R]`` batch (rows are independent), with their dropout
masks from one generator derived from ``(seed, step)``, so a resumed run
draws the masks an uninterrupted one would.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aznet_tpu_torch.config import Config
from aznet_tpu_torch.models.aznet import AZNet, RoiNet
from aznet_tpu_torch.ops.losses import sigmoid_ce_loss, smooth_l1_loss
from aznet_tpu_torch.train.optim import SGD, global_norm
from aznet_tpu_torch.utils.precision import float32_precision


@dataclasses.dataclass
class TrainState:
    """A model with float32 master weights, its optimizer and the number of
    steps taken (Flax's ``TrainState``)."""

    model: RoiNet
    opt: SGD
    step: int = 0

    def snapshot(self) -> dict:
        return {"params": self.model.state_dict(), "opt_state": self.opt.state_dict(),
                "step": self.step}

    def restore(self, tree: dict) -> None:
        self.model.load_state_dict(tree["params"])
        self.opt.load_state_dict(tree["opt_state"])
        self.step = int(tree["step"])


def make_train_state(model_cls, cfg: Config, device="cuda", state_dict=None,
                     seed=None) -> TrainState:
    """A training state on ``device`` (the card unless ``device='cpu'``):
    float32 weights from ``state_dict``, else the seeded init (``seed``,
    default ``cfg.RNG_SEED``), zero momentum."""
    from aznet_tpu_torch.api import _device, new_model

    model = new_model(model_cls, cfg, _device(device), state_dict, seed).train()
    return TrainState(model, SGD(dict(model.named_parameters()), cfg.TRAIN))


def make_az_train_state(cfg: Config, device="cuda", state_dict=None, seed=None) -> TrainState:
    return make_train_state(AZNet, cfg, device, state_dict, seed)


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout masks' generator of a step, from ``(seed, step)`` (the
    reference's ``fold_in(rng, step)``)."""
    ss = np.random.SeedSequence([int(seed) & 0x7FFFFFFF, int(step)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return gen


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def head_outputs(model: RoiNet, batch: dict, generator=None, remat_trunk: bool = False) -> dict:
    """The trunk on ``images``, then the head on every image's rois as one
    batch (training branch iff ``generator`` is given); outputs ``[B, R,
    ...]``. ``remat_trunk``: ``RoiNet.features``' ``remat``."""
    images, rois = batch["images"], batch["rois"]
    feats = model.features(images, remat=remat_trunk)
    b, r = rois.shape[:2]
    pooled = torch.cat([model.roi_pool_only(feats[i], rois[i]) for i in range(b)])
    out = model.head_forward(pooled, train=generator is not None, generator=generator)
    return {k: v.reshape((b, r) + v.shape[1:]) for k, v in out.items()}


def az_loss(model: RoiNet, batch: dict, generator=None, pos_weights=(1.0, 1.0),
            remat_trunk: bool = False):
    """The AZ loss and its metrics ``loss``, ``zoom_loss``, ``adj_loss``,
    ``bbox_loss``. ``generator`` None runs the heads' inference branch (no
    dropout); ``pos_weights``: the positive-class weights of the zoom and
    adjacency cross-entropies (``TRAIN.ZOOM_POS_WEIGHT`` /
    ``ADJ_POS_WEIGHT``)."""
    out = head_outputs(model, batch, generator, remat_trunk)
    valid = batch["roi_valid"].float()
    zw, aw = pos_weights
    zoom_w = valid * (1.0 + (zw - 1.0) * batch["zoom_labels"])
    zoom_loss = sigmoid_ce_loss(out["zoom"], batch["zoom_labels"], weights=zoom_w)
    adj_w = valid[..., None] * (1.0 + (aw - 1.0) * batch["adj_labels"])
    adj_loss = sigmoid_ce_loss(out["adj_score"], batch["adj_labels"], weights=adj_w)
    n_rois = torch.clamp(valid.sum(), min=1.0)
    bbox_loss = smooth_l1_loss(out["adj_delta"], batch["adj_targets"],
                               inside_weights=batch["adj_inside"],
                               outside_weights=valid[..., None, None]) / n_rois
    loss = zoom_loss + adj_loss + bbox_loss
    return loss, {"loss": loss, "zoom_loss": zoom_loss, "adj_loss": adj_loss,
                  "bbox_loss": bbox_loss}


def make_step(model: RoiNet, loss_fn):
    """``step(state, batch, seed) -> metrics``: one SGD update of
    ``state.model`` (which is ``model``) in place, ``state.step`` + 1. The
    metrics are the loss's, plus ``grad_norm``, the norm of the raw
    gradients (frozen parameters included), all detached 0-d tensors on the
    model's device. Float32 layers run in true float32 forward and backward
    (``utils/precision.py``: the backward runs after the forward's scopes
    have closed)."""
    names, params = zip(*model.named_parameters())

    def step(state: TrainState, batch: dict, seed: int) -> dict:
        dev = params[0].device
        batch = to_device(batch, dev)
        with float32_precision():
            loss, metrics = loss_fn(model, batch, dropout_generator(seed, state.step, dev))
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        metrics["grad_norm"] = global_norm([g for g in grads if g is not None])
        state.opt.step(dict(zip(names, grads)))
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_az_train_step(model: RoiNet, pos_weights=(1.0, 1.0), remat_trunk: bool = False):
    """The AZ step (:func:`make_step` over :func:`az_loss`)."""
    return make_step(model, lambda m, b, g: az_loss(m, b, g, pos_weights, remat_trunk))
