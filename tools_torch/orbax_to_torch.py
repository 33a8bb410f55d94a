#!/usr/bin/env python
"""Copy a snapshot of the JAX package (orbax, ``aznet_tpu.utils.checkpoint``)
into a snapshot of the PyTorch port (``aznet_tpu_torch.utils.checkpoint``),
so that the port's ``train_net`` resumes where the reference's stopped, or
its ``test_net`` evaluates the reference's weights.

    python tools_torch/orbax_to_torch.py --src output/ref_az --out output/port_az \
        --net az --cfg experiments/cfgs/az_smallnet_synthetic.yml [--set KEY VALUE ...]

This is the one file of ``tools_torch/`` that imports JAX and ``aznet_tpu``,
so it runs only where JAX is installed (not on the card's machine). Nothing
imports it: not the port, not ``chip_smoke.py``, not another tool.

A training snapshot (``{"params", "opt_state", "step"}``) is restored
through the reference's ``Checkpointer`` against a template train state of
the same config (the optax chain of ``aznet_tpu/train/optim.py``, which
``TRAIN.FREEZE_PREFIXES`` and ``GRAD_CLIP`` shape, fixes where the momentum
and the update count sit) and written as the port's ``{"params",
"opt_state": {"momentum", "count"}, "step"}`` under
``TRAIN.SNAPSHOT_PREFIX``. A params-only snapshot (a ``deploy/`` copy, a
converted one) is written params-only. Parameter and momentum trees go
through ``utils/convert.py::params_from_flax``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _find(tree, cls):
    """The one node of type ``cls`` in an optax state tree."""
    found = []

    def walk(node):  # optax states are NamedTuples (MaskedState's inner_state too)
        if isinstance(node, cls):
            found.append(node)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)

    walk(tree)
    if len(found) != 1:
        raise ValueError(f"expected one {cls.__name__} in the optimizer state, found {len(found)}")
    return found[0]


def _stored_keys(directory: str, step: int) -> set:
    """The top-level keys of the tree saved at ``step`` under ``directory``
    (``Checkpointer.save`` writes the item ``default`` of each step)."""
    import orbax.checkpoint as ocp

    md = ocp.StandardCheckpointer().metadata(os.path.join(directory, str(step), "default"))
    tree = getattr(md, "item_metadata", md)
    return set(getattr(tree, "tree", tree))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="aznet_tpu orbax snapshot -> aznet_tpu_torch snapshot")
    p.add_argument("--src", required=True, help="the JAX package's checkpoint dir")
    p.add_argument("--out", required=True, help="the port's checkpoint dir to write")
    p.add_argument("--net", choices=("az", "frcnn"), default="az")
    p.add_argument("--cfg", default=None)
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=[])
    p.add_argument("--step", type=int, default=None, help="default: the latest")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import optax
    import torch

    from aznet_tpu.config import Config, cfg_from_file, cfg_from_list
    from aznet_tpu.models import AZNet, FRCNN
    from aznet_tpu.train.train_az import make_az_train_state
    from aznet_tpu.train.train_frcnn import make_frcnn_train_state
    from aznet_tpu.utils.checkpoint import Checkpointer as OrbaxCheckpointer
    from aznet_tpu_torch.utils.checkpoint import Checkpointer
    from aznet_tpu_torch.utils.convert import params_from_flax

    cfg = Config()
    if args.cfg:
        cfg = cfg_from_file(cfg, args.cfg)
    if args.set_cfgs:
        cfg = cfg_from_list(cfg, args.set_cfgs)
    src = OrbaxCheckpointer(args.src)
    step = args.step if args.step is not None else src.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {args.src}")
    if args.net == "az":
        state = make_az_train_state(cfg, AZNet(model_cfg=cfg.MODEL), jax.random.PRNGKey(0))
    else:
        state = make_frcnn_train_state(cfg, FRCNN(model_cfg=cfg.MODEL), jax.random.PRNGKey(0))
    params_tmpl = jax.device_get(state.params)
    if "opt_state" in _stored_keys(src.directory, step):
        restored, _ = src.restore({"params": params_tmpl,
                                   "opt_state": jax.device_get(state.opt_state), "step": 0},
                                  step=step)
        trace = _find(restored["opt_state"], optax.TraceState).trace
        count = _find(restored["opt_state"], optax.ScaleByScheduleState).count
        out = {"params": params_from_flax(restored["params"]),
               "opt_state": {"momentum": params_from_flax(trace), "count": int(np.asarray(count))},
               "step": int(np.asarray(restored["step"]))}
        prefix = cfg.TRAIN.SNAPSHOT_PREFIX
    else:
        restored, _ = src.restore({"params": params_tmpl}, step=step)
        out, prefix = {"params": params_from_flax(restored["params"])}, "aznet"
    Checkpointer(args.out, prefix=prefix).save(step, out)
    n = sum(int(np.prod(t.shape)) for t in out["params"].values() if isinstance(t, torch.Tensor))
    print(f"wrote step {step} of {args.src} ({n} parameters"
          f"{', momentum and count' if 'opt_state' in out else ''}) to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
