"""Entry points of the port: the counterpart of ``__graft_entry__.py``.

``entry(device=None) -> (fn, example_args)``: the flagship forward, the
AZ-Net VGG-16 proposal step (a preprocessed image -> trunk -> zoom search
-> scored boxes) on one 224x224 image, with seeded weights, on the card
unless ``device="cpu"``. ``fn(*example_args)`` returns ``(boxes [1, 300,
4], scores [1, 300], valid [1, 300])``.

``dryrun_multichip(n)``: one AZ train step at VGG-16 ``WIDTH`` 0.25 and
``FC_DIM`` 512 on an n-rank ``('data', 'model')`` mesh (``model`` = 2 when
n is even: DP x TP of fc6/fc7), then the serving paths at smallnet (sharded
propose, latency propose with the frontier over every rank, sharded
detect), each checked finite with live proposals and reported on a line of
its own; then ``dryrun_multihost(2, max(n // 2, 2))``. On NCCL when n cards
are visible (in this process at n = 1, else one process a card); otherwise
n gloo ranks on the CPU, launched by ``parallel/multihost.py::launch``
(the reference re-executes itself on a forced n-device CPU platform).

    python -m aznet_tpu_torch.entry            # entry() on the card, once
    python -m aznet_tpu_torch.entry --cpu      # on the CPU
    python -m aznet_tpu_torch.entry --dryrun N # dryrun_multichip(N)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from aznet_tpu_torch.config import Config, cfg_from_dict

HW = (224, 224)  # the flagship forward's image


def flagship_cfg() -> Config:
    """``__graft_entry__._flagship_cfg()``: VGG-16 with a 4-level search,
    frontier 64, 1024 candidates, 300 proposals."""
    return cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "vgg16"},
        "SEAR": {"FRONTIER_CAP": 64, "CAND_BUF": 1024, "MAX_LEVELS": 4, "NUM_PROPOSALS": 300},
    })


def build_entry(cfg: Config, device="cuda", state_dict=None):
    """``(fn, (images,))`` of :func:`entry` for any config: ``fn(images [B, h,
    w, 3] preprocessed BGR floats) -> (boxes, scores, valid)``, one search per
    image over the whole ``h x w``; ``images`` one ``HW`` image uniform in
    [-120, 120] (seed 0)."""
    from aznet_tpu_torch import api
    from aznet_tpu_torch.search.propose import az_search

    net = api.build_az_net(cfg, state_dict=state_dict, device=device)
    model = net.model

    @torch.inference_mode()
    def fn(images):
        feats = model.features(images.to(api._blob_dtype(cfg)))
        outs = [az_search(model.roi_forward, f, tuple(images.shape[1:3]), cfg.SEAR,
                          num_templates=cfg.MODEL.NUM_TEMPLATES, offset=cfg.BOX_OFFSET)
                for f in feats]
        return tuple(torch.stack(t) for t in zip(*outs))

    images = np.random.RandomState(0).uniform(-120, 120, (1, *HW, 3))
    return fn, (torch.from_numpy(images.astype(np.float32)).to(net.device),)


def entry(device=None):
    """The flagship forward (see the module's docstring); on the card unless
    ``device`` says otherwise."""
    return build_entry(flagship_cfg(), "cuda" if device is None else device)


def dryrun_multihost(num_processes: int = 2, devices_per_proc: int = 4) -> str:
    """The multi-host input path's dry run (``parallel/multihost.py``): each
    of ``num_processes`` simulated hosts shards the roidb, builds its local
    batch and takes its rows of the global batch; one sharded train step on
    the CPU over gloo. Returns rank 0's report line."""
    from aznet_tpu_torch.parallel.multihost import run_multihost_dryrun

    return run_multihost_dryrun(num_processes, devices_per_proc)


def dryrun_multichip(n_devices: int) -> None:
    """See the module's docstring. Raises when a rank fails."""
    from aznet_tpu_torch.parallel.multihost import launch

    on_card = torch.cuda.is_available() and torch.cuda.device_count() >= n_devices
    if on_card and n_devices == 1:
        import torch.distributed as dist

        started = not dist.is_initialized()
        try:
            _dryrun_rank(1, "cuda")
        finally:
            if started and dist.is_initialized():
                dist.destroy_process_group()
    else:
        outs = launch(n_devices, "aznet_tpu_torch.entry:_dryrun_rank",
                      (n_devices, "cuda" if on_card else "cpu"),
                      backend="nccl" if on_card else "gloo", timeout=600)
        sys.stdout.write(outs[0])
    dryrun_multihost(2, max(n_devices // 2, 2))


def _dryrun_rank(n_devices: int, device: str) -> None:
    """One rank of :func:`dryrun_multichip`: the train step, then serving."""
    import torch.distributed as dist

    from aznet_tpu_torch.parallel import make_mesh
    from aznet_tpu_torch.train.loop import make_global_batch
    from aznet_tpu_torch.train.train_az import make_az_train_state, make_az_train_step

    cfg = cfg_from_dict(Config(), {
        # The flagship VGG-16 structure (layer names, fc6/fc7 split over
        # 'model', the batch over 'data') at a quarter width.
        "MODEL": {"BACKBONE": "vgg16", "WIDTH": 0.25, "FC_DIM": 512},
        "TRAIN": {"LEARNING_RATE": 0.001},
    })
    mp = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, model_parallel=mp, device=device)
    lead = dist.get_rank() == 0
    state = make_az_train_state(cfg, device=device, seed=0, mesh=mesh)
    b, r, k = mesh.shape["data"] * 2, 4, cfg.MODEL.NUM_TEMPLATES
    rng = np.random.RandomState(0)
    rois = rng.uniform(0, 16, (b, r, 4)).astype(np.float32)
    rois[..., 2:] += 15.0
    batch = {
        "images": rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32),
        "rois": rois,
        "roi_valid": np.ones((b, r), bool),
        "zoom_labels": rng.randint(0, 2, (b, r)).astype(np.float32),
        "adj_labels": rng.randint(0, 2, (b, r, k)).astype(np.float32),
        "adj_targets": rng.normal(0, 0.1, (b, r, k, 4)).astype(np.float32),
        "adj_inside": np.ones((b, r, k, 4), np.float32),
    }
    metrics = make_az_train_step(state.model, mesh=mesh)(state, make_global_batch(batch, mesh), 1)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss in the multichip dry run: {loss}")
    if lead:
        print(f"dryrun_multichip({n_devices}): mesh={mesh.shape} backend={dist.get_backend()} "
              f"loss={loss:.4f} OK", flush=True)
    _dryrun_serving(mesh, n_devices, lead)


def _dryrun_serving(mesh, n_devices: int, lead: bool) -> None:
    """The serving paths on the same mesh shape, smallnet float32: sharded
    propose, latency propose (one image, its frontier over every rank) and
    sharded detect, each checked finite with live proposals."""
    from aznet_tpu_torch import api
    from aznet_tpu_torch.parallel.inference import (make_latency_propose, make_sharded_detect,
                                                    make_sharded_propose)

    cfg = cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 64, "NUM_TEMPLATES": 5,
                  "COMPUTE_DTYPE": "float32", "DROPOUT": 0.0},
        "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 2, "NUM_PROPOSALS": 20},
        "TEST": {"SCALES": (64,), "MAX_SIZE": 64},
    })
    canvas = (64, 64)
    rng = np.random.RandomState(1)
    b = mesh.shape["data"] * 2
    images = torch.from_numpy(rng.randint(0, 256, (b, 64, 64, 3)).astype(np.uint8)).to(
        mesh.device)

    az = api.build_az_net(cfg, device=mesh.device, seed=0)
    boxes, scores, valid = make_sharded_propose(az.model, cfg, canvas, mesh)(images)
    _check_live("sharded propose", boxes, scores, valid)
    if lead:
        print(f"dryrun_serving sharded_propose(DP={mesh.shape['data']}): "
              f"boxes={tuple(boxes.shape)} live={int(valid.sum())} OK", flush=True)
    lb, ls, lv = make_latency_propose(az.model, cfg, canvas, mesh)(images[0])
    _check_live("latency propose", lb, ls, lv)
    if lead:
        print(f"dryrun_serving latency_propose(regions over {n_devices} devices): "
              f"boxes={tuple(lb.shape)} live={int(lv.sum())} OK", flush=True)

    frcnn = api.build_frcnn_net(cfg, device=mesh.device, seed=0)
    rois = rng.uniform(0, 32, (b, 8, 4)).astype(np.float32)
    rois[..., 2:] += 31.0
    cls_scores, pred_boxes = make_sharded_detect(frcnn.model, cfg, canvas, mesh)(
        images, torch.from_numpy(rois).to(mesh.device))
    if not (torch.isfinite(cls_scores).all() and torch.isfinite(pred_boxes).all()):
        raise RuntimeError("sharded detect: non-finite outputs")
    if lead:
        print(f"dryrun_serving sharded_detect(DP={mesh.shape['data']}): "
              f"scores={tuple(cls_scores.shape)} preds={tuple(pred_boxes.shape)} OK", flush=True)


def _check_live(tag, boxes, scores, valid) -> None:
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores[valid]).all()
            and int(valid.sum()) > 0):
        raise RuntimeError(f"{tag}: non-finite outputs or no live proposal")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="aznet_tpu_torch entry points")
    p.add_argument("--cpu", action="store_true", help="run entry() on the CPU")
    p.add_argument("--dryrun", type=int, default=0, metavar="N",
                   help="run dryrun_multichip(N) in place of entry()")
    args = p.parse_args(argv)
    if args.dryrun:
        dryrun_multichip(args.dryrun)
        return 0
    fn, example = entry("cpu" if args.cpu else None)
    boxes, scores, valid = fn(*example)
    print(f"entry() run OK: {tuple(boxes.shape)} {int(valid.sum())} proposals", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
