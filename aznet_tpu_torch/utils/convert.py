"""Flax parameter tree -> the port's ``state_dict``.

``params_from_flax(tree)`` takes the JAX package's parameters as NumPy
arrays (``{"params": {"trunk": {"conv1_1": {"kernel", "bias"}}, "head":
...}}``, or the inner ``"params"`` dict) and names them as the port's
modules do (``trunk.conv1_1.weight``, ``head.fc.fc6.bias``, ...):

- conv kernels HWIO -> OIHW;
- Dense kernels ``[in, out]`` -> Linear weights ``[out, in]``;
- fc6's input rows stay in the reference's NHWC ``[R, P, P, C]`` flatten
  order: the port's ROI align pools into NHWC before the flatten, so no
  permutation of fc6 is needed.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def params_from_flax(tree: Mapping) -> dict:
    """NumPy Flax tree -> ``{name: float32 torch.Tensor}``."""
    if "params" in tree:
        tree = tree["params"]
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
                continue
            t = torch.from_numpy(np.array(val, dtype=np.float32))
            if key == "kernel":
                t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.t()
                out[f"{prefix}weight"] = t.contiguous()
            elif key == "bias":
                out[f"{prefix}bias"] = t
            else:
                raise KeyError(f"unexpected parameter {prefix}{key}")

    walk(tree, "")
    return out
