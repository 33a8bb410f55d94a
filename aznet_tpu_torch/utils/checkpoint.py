"""Snapshots (``torch.save``) and the reference's bbox-weight baking
(``aznet_tpu/utils/checkpoint.py``, which keeps orbax snapshots: the port
reads only its own).

Caffe's ``SolverWrapper.snapshot`` bakes the bbox-target normalization into
the regression layer so that inference needs no normalization metadata;
:func:`bake_bbox_normalization` / :func:`unbake_bbox_normalization` do the
same on a state dict. A torch ``Linear`` stores ``[out, in]``, so the rows
of the weight are scaled (Flax's ``[in, out]`` kernel has its columns
scaled).
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch


def _map_head(params: dict, head_name: str, fn) -> dict:
    """``fn(weight, bias) -> (weight, bias)`` on every Linear whose dotted
    name has the component ``head_name``; a new dict."""
    out = dict(params)
    hits = [k for k in params if head_name in k.split(".")[:-1] and k.endswith(".weight")]
    if not hits:
        raise KeyError(f"no Linear head named {head_name!r} in params")
    for wk in hits:
        bk = wk[:-len("weight")] + "bias"
        out[wk], out[bk] = fn(params[wk], params[bk])
    return out


def _tiled(v, reps: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.tile(np.asarray(v, np.float32), reps)).to(like.device)


def bake_bbox_normalization(params: dict, means, stds, head_name: str = "adj_bbox") -> dict:
    """``W' = W * std`` (per output row), ``b' = b * std + mean``, with the
    per-coordinate ``(4,)`` means / stds tiled over the head's 4K outputs:
    the head then outputs unnormalized deltas."""
    def fn(w, b):
        std, mean = _tiled(stds, b.shape[-1] // 4, b), _tiled(means, b.shape[-1] // 4, b)
        return w * std[:, None], b * std + mean

    return _map_head(params, head_name, fn)


def unbake_bbox_normalization(params: dict, means, stds, head_name: str = "adj_bbox") -> dict:
    """The inverse of :func:`bake_bbox_normalization`."""
    def fn(w, b):
        std, mean = _tiled(stds, b.shape[-1] // 4, b), _tiled(means, b.shape[-1] // 4, b)
        return w / std[:, None], (b - mean) / std

    return _map_head(params, head_name, fn)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _select(tmpl, stored):
    if isinstance(tmpl, dict):
        if not isinstance(stored, dict) or not set(tmpl) <= set(stored):
            raise KeyError(f"the snapshot has no {sorted(set(tmpl) - set(stored or {}))}")
        return {k: _select(v, stored[k]) for k, v in tmpl.items()}
    return stored


class Checkpointer:
    """Snapshots of a nested dict (tensors, numbers) in ``directory``, one
    file per step, ``<prefix>_<step>.pt``; the newest ``max_to_keep`` stay."""

    def __init__(self, directory: str, prefix: str = "aznet", max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.prefix = prefix
        self.max_to_keep = max_to_keep
        self._name = re.compile(rf"^{re.escape(prefix)}_(\d+)\.pt$")
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{step}.pt")

    def all_steps(self) -> list:
        return sorted(int(m.group(1)) for m in map(self._name.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Write the snapshot of ``step`` (tensors copied to the host); a step
        that exists already is kept as it is."""
        if step in self.all_steps():
            print(f"[checkpoint] step {step} already exists in {self.directory}; skipping save")
            return
        tmp = self.path(step) + ".tmp"
        torch.save(_to_cpu(state), tmp)
        os.replace(tmp, self.path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def restore(self, state_template: Any, step: Optional[int] = None) -> Tuple[Any, int]:
        """The snapshot of ``step`` (default: the latest), cut to the keys of
        ``state_template``, which may be a sub-tree of what was saved (the
        parameters only of a parameters + optimizer snapshot). Tensors come
        back on the host. Returns ``(state, step)``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        stored = torch.load(self.path(step), map_location="cpu", weights_only=True)
        return _select(state_template, stored), step
