"""What every tool of ``tools_torch/`` does the same way: read the config
(``Config()``, then ``--cfg``, then ``--set``), pick the device (the card
unless ``--cpu``), and restore a net from a snapshot directory, preferring
its ``deploy/`` copy (the bbox normalization baked into the regression
layer, which decoding raw head outputs needs)."""

from __future__ import annotations

import os

from aznet_tpu_torch.config import Config, cfg_from_file, cfg_from_list


def load_config(cfg_file=None, set_cfgs=()) -> Config:
    cfg = Config()
    if cfg_file:
        cfg = cfg_from_file(cfg, cfg_file)
    if set_cfgs:
        cfg = cfg_from_list(cfg, list(set_cfgs))
    return cfg


def device(args) -> str:
    """``'cpu'`` with ``--cpu``, else ``'cuda'``: the API raises where there
    is no card; nothing falls back to the CPU."""
    return "cpu" if args.cpu else "cuda"


def snapshot_dir(ckpt_dir: str, prefer_deploy: bool = True) -> str:
    deploy = os.path.join(ckpt_dir, "deploy")
    return deploy if prefer_deploy and os.path.isdir(deploy) else ckpt_dir


def restore_params(ckpt_dir: str, cfg: Config, prefer_deploy: bool = True):
    """``(state_dict, step, path)`` of the latest snapshot under ``ckpt_dir``
    (its ``deploy/`` copy where there is one and ``prefer_deploy``)."""
    from aznet_tpu_torch.utils.checkpoint import Checkpointer

    path = snapshot_dir(ckpt_dir, prefer_deploy)
    # Training snapshots carry TRAIN.SNAPSHOT_PREFIX; deploy copies and
    # converted weights the default prefix.
    for prefix in dict.fromkeys((cfg.TRAIN.SNAPSHOT_PREFIX, "aznet")):
        ckpt = Checkpointer(path, prefix=prefix)
        if ckpt.latest_step() is not None:
            break
    restored, step = ckpt.restore({"params": 0})
    return restored["params"], step, path


def load_net(make_net, cfg: Config, ckpt_dir, dev, prefer_deploy: bool = True, **kwargs):
    """``make_net(cfg)`` on ``dev``, from the snapshot under ``ckpt_dir`` when
    one is given, else from the seeded init."""
    state_dict = None
    if ckpt_dir:
        state_dict, step, path = restore_params(ckpt_dir, cfg, prefer_deploy)
        print(f"restored step {step} from {path}")
    return make_net(cfg, state_dict=state_dict, device=dev, **kwargs)


def card_line(dev) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``cpu``."""
    if str(dev) == "cpu":
        return "cpu"
    import subprocess

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}"
