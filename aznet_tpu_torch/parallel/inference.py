"""Sharded and region-parallel inference over the mesh
(``aznet_tpu/parallel/inference.py``).

The parameters are replicated: every rank holds the whole inference net.
Each function takes the GLOBAL input on every rank and returns the GLOBAL
output on every rank, as the reference's jitted functions do:

- :func:`make_sharded_propose` / :func:`make_sharded_detect`: each rank runs
  the images of its ``data`` coordinate, then the outputs are all-gathered
  over ``data`` (ranks of one ``model`` group run the same images);
- :func:`region_roi_wrap`: within one image, the search frontier of every
  level is cut into equal contiguous parts over the ranks of ``axes``; each
  rank pools its part and runs the head on it, and the head's outputs are
  all-gathered. The feature map stays replicated, so every rank of the
  group walks the same search in lockstep;
- :func:`make_latency_propose`: one image, its frontier over every rank of
  the mesh.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aznet_tpu_torch.api import make_detect_batch, make_propose_batch
from aznet_tpu_torch.parallel.mesh import AXES, Mesh, all_gather


def _data_rows(mesh: Mesh, b: int) -> slice:
    data = mesh.shape["data"]
    if b % data:
        raise ValueError(f"batch of {b} does not split over data={data}")
    per = b // data
    return slice(mesh.coords["data"] * per, (mesh.coords["data"] + 1) * per)


def _gather_data(outs, mesh: Mesh) -> tuple:
    return tuple(all_gather(t, mesh.group("data")) for t in outs)


def region_roi_wrap(mesh: Mesh, axes=("model",)):
    """A decorator of ``roi_fwd(feat, rois [R, 4]) -> {name: [R, ...]}``:
    the R rows in equal contiguous parts over the group of ``axes`` (zero
    rows padded up to a multiple of its size), this rank's part through
    ``roi_fwd``, each output all-gathered and the pad dropped."""
    group, size, rank = mesh.group(axes), mesh.size(axes), mesh.rank(axes)

    def wrap(roi_fwd):
        def wrapped(feat, rois):
            r = rois.shape[0]
            per = -(-r // size)
            rois = F.pad(rois, (0, 0, 0, per * size - r))
            out = roi_fwd(feat, rois[rank * per:(rank + 1) * per])
            return {k: all_gather(v, group)[:r] for k, v in out.items()}

        return wrapped

    return wrap


def make_sharded_propose(model, cfg, canvas_hw, mesh: Mesh, shard_regions: bool = False):
    """``fn(images [B, H, W, 3] raw) -> (boxes, scores, valid)`` with B split
    over ``data`` (B must divide by its size). ``shard_regions=True`` also
    splits each image's frontier over ``model`` (region parallelism: for
    small, latency-bound batches; pure DP wins at large B)."""
    wrap = region_roi_wrap(mesh) if shard_regions else None
    fn = make_propose_batch(model, cfg, canvas_hw, roi_wrap=wrap)

    @torch.inference_mode()
    def sharded(images):
        return _gather_data(fn(images[_data_rows(mesh, images.shape[0])]), mesh)

    return sharded


def make_latency_propose(model, cfg, canvas_hw, mesh: Mesh):
    """One image, ``fn(image [H, W, 3]) -> (boxes, scores, valid)``, its
    search frontier split over every rank of the mesh (both axes)."""
    fn = make_propose_batch(model, cfg, canvas_hw, roi_wrap=region_roi_wrap(mesh, AXES))

    def single(image):
        return tuple(t[0] for t in fn(image[None]))

    return single


def make_sharded_detect(model, cfg, canvas_hw, mesh: Mesh):
    """``fn(images [B, H, W, 3], boxes [B, R, 4]) -> (scores, pred_boxes)``
    with the images and their boxes split over ``data``."""
    fn = make_detect_batch(model, cfg, canvas_hw)

    @torch.inference_mode()
    def sharded(images, boxes):
        rows = _data_rows(mesh, images.shape[0])
        return _gather_data(fn(images[rows], boxes[rows]), mesh)

    return sharded
