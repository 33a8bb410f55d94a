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

Under a mesh (``parallel/mesh.py``) each rank holds its ``data`` rows of the
global batch (``train/loop.py::make_global_batch``) and fc6/fc7's rows over
``model``. Every loss term divides by a batch-wide sum (the weights' sum,
``n_rois``), summed over ``data`` before the clamp, so each rank's loss is
its share of the global loss; the gradients and the metrics are then
summed over ``data`` (one all-reduce each), and the global norm sums the
sharded gradients' squares over ``model``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from aznet_tpu_torch.config import Config
from aznet_tpu_torch.models.aznet import AZNet, RoiNet
from aznet_tpu_torch.ops.losses import sigmoid_ce_loss, smooth_l1_loss
from aznet_tpu_torch.parallel.mesh import (Mesh, all_reduce, gather_rows, model_sharded,
                                           shard_module, slice_rows)
from aznet_tpu_torch.train.optim import SGD
from aznet_tpu_torch.utils.precision import float32_precision


@dataclasses.dataclass
class TrainState:
    """A model with float32 master weights, its optimizer and the number of
    steps taken (Flax's ``TrainState``). Under ``mesh``, ``placements``
    says which parameters (and momentum buffers) are split over ``model``:
    :meth:`snapshot` gathers them (every rank calls it) and :meth:`restore`
    slices a single-process tree, so snapshots keep one layout."""

    model: RoiNet
    opt: SGD
    step: int = 0
    mesh: Optional[Mesh] = None
    placements: Optional[dict] = None

    def snapshot(self) -> dict:
        tree = {"params": self.model.state_dict(), "opt_state": self.opt.state_dict(),
                "step": self.step}
        return tree if self.mesh is None else gather_rows(tree, self.mesh, self.placements)

    def restore(self, tree: dict) -> None:
        if self.mesh is not None:
            tree = slice_rows(tree, self.mesh, self.placements)
        self.model.load_state_dict(tree["params"])
        self.opt.load_state_dict(tree["opt_state"])
        self.step = int(tree["step"])

    def full_state_dict(self) -> dict:
        """The parameters in the single-process layout (every rank calls it
        under a mesh)."""
        sd = self.model.state_dict()
        return sd if self.mesh is None else gather_rows(sd, self.mesh, self.placements)


def make_train_state(model_cls, cfg: Config, device="cuda", state_dict=None,
                     seed=None, mesh: Optional[Mesh] = None) -> TrainState:
    """A training state on ``device`` (the card unless ``device='cpu'``):
    float32 weights from ``state_dict``, else the seeded init (``seed``,
    default ``cfg.RNG_SEED``), zero momentum. Under ``mesh`` the state lives
    on the mesh's device (of ``device``'s type) with fc6/fc7 split over
    ``model`` after the whole model is made, so the init is the
    single-process one."""
    from aznet_tpu_torch.api import _device, new_model

    if mesh is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {device!r} and a mesh on {mesh.device}")
    dev = _device(device) if mesh is None else mesh.device
    model = new_model(model_cls, cfg, dev, state_dict, seed).train()
    if mesh is None:
        return TrainState(model, SGD(dict(model.named_parameters()), cfg.TRAIN))
    placements = shard_module(model, mesh)
    sharded = [n for n, p in placements.items() if model_sharded(p)]
    opt = SGD(dict(model.named_parameters()), cfg.TRAIN, sharded,
              lambda t: all_reduce(t, mesh.group("model")))
    return TrainState(model, opt, mesh=mesh, placements=placements)


def make_az_train_state(cfg: Config, device="cuda", state_dict=None, seed=None,
                        mesh: Optional[Mesh] = None) -> TrainState:
    return make_train_state(AZNet, cfg, device, state_dict, seed, mesh)


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
    if getattr(model.trunk, "level_strides", None):
        raise NotImplementedError(f"backbone {model.model_cfg.BACKBONE!r}: its feature pyramid "
                                  "has no train step")
    images, rois = batch["images"], batch["rois"]
    feats = model.features(images, remat=remat_trunk)
    b, r = rois.shape[:2]
    pooled = torch.cat([model.roi_pool_only(feats[i], rois[i]) for i in range(b)])
    out = model.head_forward(pooled, train=generator is not None, generator=generator)
    return {k: v.reshape((b, r) + v.shape[1:]) for k, v in out.items()}


def batch_total(total, t: torch.Tensor) -> torch.Tensor:
    """``t``, a local sum, made batch-wide by ``total`` (None: one process)."""
    return t if total is None else total(t)


def az_loss(model: RoiNet, batch: dict, generator=None, pos_weights=(1.0, 1.0),
            remat_trunk: bool = False, total=None):
    """The AZ loss and its metrics ``loss``, ``zoom_loss``, ``adj_loss``,
    ``bbox_loss``. ``generator`` None runs the heads' inference branch (no
    dropout); ``pos_weights``: the positive-class weights of the zoom and
    adjacency cross-entropies (``TRAIN.ZOOM_POS_WEIGHT`` /
    ``ADJ_POS_WEIGHT``); ``total``: the sum of a normaliser over the
    data-parallel ranks (None: one process)."""
    out = head_outputs(model, batch, generator, remat_trunk)
    valid = batch["roi_valid"].float()
    zw, aw = pos_weights
    zoom_w = valid * (1.0 + (zw - 1.0) * batch["zoom_labels"])
    zoom_loss = sigmoid_ce_loss(out["zoom"], batch["zoom_labels"], weights=zoom_w, total=total)
    adj_w = valid[..., None] * (1.0 + (aw - 1.0) * batch["adj_labels"])
    adj_loss = sigmoid_ce_loss(out["adj_score"], batch["adj_labels"], weights=adj_w,
                               total=total)
    n_rois = torch.clamp(batch_total(total, valid.sum()), min=1.0)
    bbox_loss = smooth_l1_loss(out["adj_delta"], batch["adj_targets"],
                               inside_weights=batch["adj_inside"],
                               outside_weights=valid[..., None, None]) / n_rois
    loss = zoom_loss + adj_loss + bbox_loss
    return loss, {"loss": loss, "zoom_loss": zoom_loss, "adj_loss": adj_loss,
                  "bbox_loss": bbox_loss}


def sum_over_data(tensors, mesh: Mesh) -> list:
    """Each tensor of ``tensors`` (None stays None) summed over ``data``, in
    one all-reduce of their concatenation."""
    live = [t.detach() for t in tensors if t is not None]
    flat = all_reduce(torch.cat([t.reshape(-1) for t in live]), mesh.group("data"))
    parts = iter(flat.split([t.numel() for t in live]))
    return [None if t is None else next(parts).view_as(t) for t in tensors]


def make_step(model: RoiNet, loss_fn, mesh: Optional[Mesh] = None):
    """``step(state, batch, seed) -> metrics``: one SGD update of
    ``state.model`` (which is ``model``) in place, ``state.step`` + 1. The
    metrics are the loss's, plus ``grad_norm``, the norm of the raw
    gradients (frozen parameters included), all detached 0-d tensors on the
    model's device. Float32 layers run in true float32 forward and backward
    (``utils/precision.py``: the backward runs after the forward's scopes
    have closed). ``loss_fn(model, batch, generator, total)``. Under
    ``mesh``, ``batch`` holds this rank's rows and the gradients and
    metrics are summed over ``data``."""
    names, params = zip(*model.named_parameters())
    total = None
    if mesh is not None:
        def total(t):
            return all_reduce(t.detach().clone(), mesh.group("data"))

    def step(state: TrainState, batch: dict, seed: int) -> dict:
        dev = params[0].device
        batch = to_device(batch, dev)
        with float32_precision():
            loss, metrics = loss_fn(model, batch, dropout_generator(seed, state.step, dev), total)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            grads = sum_over_data(grads, mesh)
            metrics = dict(zip(metrics, sum_over_data(list(metrics.values()), mesh)))
        metrics["grad_norm"] = state.opt.norm(dict(zip(names, grads)))
        state.opt.step(dict(zip(names, grads)))
        state.step += 1
        return metrics

    return step


def make_az_train_step(model: RoiNet, pos_weights=(1.0, 1.0), remat_trunk: bool = False,
                       mesh: Optional[Mesh] = None):
    """The AZ step (:func:`make_step` over :func:`az_loss`)."""
    return make_step(model, lambda m, b, g, t: az_loss(m, b, g, pos_weights, remat_trunk, t),
                     mesh)
