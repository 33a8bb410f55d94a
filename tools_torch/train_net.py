#!/usr/bin/env python
"""Train AZ-Net or Fast R-CNN on an imdb with the PyTorch port (the
counterpart of ``tools/train_net.py``), on the card unless ``--cpu``.

Examples:
  python tools_torch/train_net.py --net az --imdb synthetic_train --iters 500
  python tools_torch/train_net.py --net frcnn --imdb synthetic_hard_train \
      --cfg experiments/cfgs/az_vgg_w100_synthetic_hard.yml --proposals out/props.pkl

  torchrun --nproc-per-node 4 tools_torch/train_net.py --net az --mesh 2x2

The loop resumes from the latest snapshot in the output directory.
``--mesh DATA[xMODEL]`` trains data + tensor parallel over a ``('data',
'model')`` mesh of DATA x MODEL ranks (``parallel/mesh.py``): under
``torchrun`` (one process a card, NCCL) or any launcher that starts the
process group first (``parallel/multihost.py::launch``, gloo with
``--cpu``); ``--mesh 1`` runs in one process, in a group of one rank that
the tool starts and ends. ``--debug-nans`` turns on autograd's anomaly
detection with its NaN check for the run.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools_torch import _common  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train an aznet_tpu_torch network")
    p.add_argument("--net", choices=("az", "frcnn"), default="az")
    p.add_argument("--imdb", default="synthetic_train")
    p.add_argument("--cfg", default=None, help="YAML config override file")
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=[],
                   help="KEY VALUE config override pairs")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--output", default=None, help="output/checkpoint dir")
    p.add_argument("--proposals", default=None,
                   help="frcnn: pickle of per-image proposal arrays")
    p.add_argument("--resume", default=None,
                   help="checkpoint dir to resume from (the output dir: the loop "
                        "resumes from its latest snapshot)")
    p.add_argument("--init-trunk-from", default=None, metavar="CKPT",
                   help="checkpoint dir whose trunk params initialize this net's "
                        "trunk; unless --trunk-trainable, the trunk is added to "
                        "TRAIN.FREEZE_PREFIXES so it stays byte-identical and "
                        "share_trunk/the fused detect program apply")
    p.add_argument("--trunk-trainable", action="store_true",
                   help="with --init-trunk-from: warm-start the trunk but keep it "
                        "trainable (no freeze)")
    p.add_argument("--init-trunk-type", choices=("az", "frcnn"), default=None,
                   help="net type of the --init-trunk-from checkpoint (default: the "
                        "opposite of --net; the trunk entries are the same)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--mesh", default=None,
                   help="data[xmodel] device mesh, e.g. 4 (DP) or 4x2 (DP x TP over fc6/fc7)")
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd anomaly detection with its NaN check")
    return p.parse_args(argv)


def mesh_from_args(args, dev):
    """The ``--mesh`` mesh, or None; and whether this call started the
    process group (the tool then ends it)."""
    if not args.mesh:
        return None, False
    import torch.distributed as dist

    from aznet_tpu_torch.parallel import make_mesh

    parts = [int(v) for v in args.mesh.split("x")]
    data, model = parts[0], parts[1] if len(parts) > 1 else 1
    started = not dist.is_initialized()
    mesh = make_mesh(data * model, model_parallel=model, device=dev)
    if mesh is None:
        raise SystemExit(f"--mesh {args.mesh}: rank {dist.get_rank()} is outside the mesh")
    print(f"mesh: {mesh.shape}")
    return mesh, started and dist.is_initialized()


def trunk_init_state(args, cfg, dev, mesh=None):
    """``(cfg', state)`` warm-started from ``--init-trunk-from``, or ``(cfg,
    None)``. Unless ``--trunk-trainable``, ``trunk`` joins
    ``TRAIN.FREEZE_PREFIXES``: no gradient, no weight decay, no update."""
    if not args.init_trunk_from:
        return cfg, None
    import dataclasses

    import torch

    from aznet_tpu_torch.train.train_az import make_az_train_state
    from aznet_tpu_torch.train.train_frcnn import make_frcnn_train_state

    frozen = not args.trunk_trainable
    if frozen and "trunk" not in cfg.TRAIN.FREEZE_PREFIXES:
        cfg = dataclasses.replace(cfg, TRAIN=dataclasses.replace(
            cfg.TRAIN, FREEZE_PREFIXES=cfg.TRAIN.FREEZE_PREFIXES + ("trunk",)))
    donor = args.init_trunk_type or ("frcnn" if args.net == "az" else "az")
    params, step, path = _common.restore_params(args.init_trunk_from, cfg)
    print(f"init trunk from {donor} ckpt {path} (step {step}); "
          f"trunk {'frozen' if frozen else 'trainable (warm start)'}")
    make = make_az_train_state if args.net == "az" else make_frcnn_train_state
    state = make(cfg, device=dev, mesh=mesh)
    own = {k: v for k, v in state.model.state_dict().items() if k.startswith("trunk.")}
    if set(own) != {k for k in params if k.startswith("trunk.")}:
        raise KeyError(f"{path}: its trunk entries differ from this net's")
    with torch.no_grad():
        for k, v in own.items():
            v.copy_(params[k])
    return cfg, state


def frcnn_proposals(args, cfg):
    """``i -> boxes``: the ``--proposals`` pickle, else jittered gt boxes
    (bootstrap mode)."""
    if args.proposals:
        with open(args.proposals, "rb") as f:
            props = pickle.load(f)
        return lambda i: props[i % len(props)]
    import numpy as np

    from aznet_tpu_torch.data.imdb import get_imdb
    from aznet_tpu_torch.train.labels import perturb_gt_regions

    imdb = get_imdb(args.imdb)
    rng = np.random.RandomState(cfg.RNG_SEED)

    def proposals_fn(i):
        e = imdb.roidb[i % len(imdb.roidb)]
        return perturb_gt_regions(e["boxes"], (e["height"], e["width"]), 16, rng)

    return proposals_fn


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.resume and args.output and os.path.abspath(args.resume) != os.path.abspath(
            args.output):
        raise SystemExit("--resume: the loop resumes from the latest snapshot in its output "
                         "dir; give one directory")
    output = args.output or args.resume
    cfg = _common.load_config(args.cfg, args.set_cfgs)
    dev = _common.device(args)

    import torch

    from aznet_tpu_torch.train.loop import train_az_net, train_frcnn_net

    name = torch.cuda.get_device_name(0) if dev == "cuda" and torch.cuda.is_available() else ""
    print(f"devices: [{dev}{f' ({name})' if name else ''}]")
    print(f"imdb: {args.imdb}  net: {args.net}")
    anomaly = (torch.autograd.set_detect_anomaly(True, check_nan=True) if args.debug_nans
               else contextlib.nullcontext())
    mesh, started = mesh_from_args(args, dev)
    try:
        with anomaly:
            if args.net == "az":
                cfg, state = trunk_init_state(args, cfg, dev, mesh)
                _, _, outdir = train_az_net(cfg, args.imdb, max_iters=args.iters,
                                            output_dir=output, state=state, device=dev,
                                            mesh=mesh)
            else:
                proposals_fn = frcnn_proposals(args, cfg)
                cfg, state = trunk_init_state(args, cfg, dev, mesh)
                _, _, outdir = train_frcnn_net(cfg, args.imdb, proposals_fn,
                                               max_iters=args.iters, output_dir=output,
                                               state=state, proposals_path=args.proposals or None,
                                               device=dev, mesh=mesh)
    finally:
        if started:
            torch.distributed.destroy_process_group()
    print(f"done; checkpoints in {outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
