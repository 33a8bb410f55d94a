"""Adjacency templates and zoom division (``aznet_tpu/search/templates.py``).

The 11-template and 5-division tables are copied here as data, because the
reference module imports JAX at its top; a test holds the copies equal to
the originals. Normalized boxes (x1, y1, x2, y2) in a region's unit frame.
"""

from __future__ import annotations

import numpy as np
import torch

# Whole region, 4 halves, 4 quadrants, centre, 1.5x context window.
_TEMPLATES_11 = np.array(
    [
        [0.00, 0.00, 1.00, 1.00],
        [0.00, 0.00, 0.50, 1.00],
        [0.50, 0.00, 1.00, 1.00],
        [0.00, 0.00, 1.00, 0.50],
        [0.00, 0.50, 1.00, 1.00],
        [0.00, 0.00, 0.50, 0.50],
        [0.50, 0.00, 1.00, 0.50],
        [0.00, 0.50, 0.50, 1.00],
        [0.50, 0.50, 1.00, 1.00],
        [0.25, 0.25, 0.75, 0.75],
        [-0.25, -0.25, 1.25, 1.25],
    ],
    dtype=np.float32,
)

# Zoom division: 4 quadrants + centre, at half size.
_DIVISIONS = np.array(
    [
        [0.00, 0.00, 0.50, 0.50],
        [0.50, 0.00, 1.00, 0.50],
        [0.00, 0.50, 0.50, 1.00],
        [0.50, 0.50, 1.00, 1.00],
        [0.25, 0.25, 0.75, 0.75],
    ],
    dtype=np.float32,
)

NUM_DIVISIONS = len(_DIVISIONS)


def adjacency_templates_np(k: int = 11) -> np.ndarray:
    """The ``(K, 4)`` template table as NumPy."""
    if k <= len(_TEMPLATES_11):
        return _TEMPLATES_11[:k]
    raise ValueError(f"no template table with K={k}")


def adjacency_templates(k: int = 11, device=None) -> torch.Tensor:
    return torch.as_tensor(adjacency_templates_np(k), device=device)


def _apply_normalized(regions, table, offset: float):
    """Normalized boxes ``table [K, 4]`` in each region's frame ->
    ``[..., K, 4]`` image boxes."""
    w = regions[..., 2] - regions[..., 0] + offset
    h = regions[..., 3] - regions[..., 1] + offset
    x1 = regions[..., 0, None]
    y1 = regions[..., 1, None]
    w, h = w[..., None], h[..., None]
    tx1, ty1, tx2, ty2 = table.unbind(-1)
    return torch.stack([x1 + tx1 * w, y1 + ty1 * h,
                        x1 + tx2 * w - offset, y1 + ty2 * h - offset], dim=-1)


def template_boxes(regions, templates=None, offset: float = 1.0):
    """Anchor boxes for each region x template: ``[..., 4] -> [..., K, 4]``."""
    if templates is None:
        templates = adjacency_templates()
    return _apply_normalized(regions, torch.as_tensor(templates, device=regions.device), offset)


def division_table(div_overlap: float = 0.0) -> np.ndarray:
    """The ``(5, 4)`` sub-region table, each child grown about its centre by
    ``div_overlap``."""
    table = _DIVISIONS
    if div_overlap:
        centers = (table[:, :2] + table[:, 2:]) / 2.0
        half = (table[:, 2:] - table[:, :2]) / 2.0 * (1.0 + div_overlap)
        table = np.concatenate([centers - half, centers + half], axis=1).astype(np.float32)
    return table


def divide_regions(regions, div_overlap: float = 0.0, offset: float = 1.0):
    """Zoom subdivision: ``[..., 4] -> [..., 5, 4]`` children."""
    table = torch.as_tensor(division_table(div_overlap), device=regions.device)
    return _apply_normalized(regions, table, offset)


def division_tree_regions(im_hw, levels: int, offset: float = 1.0,
                          div_overlap: float = 0.0) -> np.ndarray:
    """All regions of the full division tree down to ``levels``, as float32
    NumPy ``[1 + 5 + ... + 5**levels, 4]``: the whole image, then each
    level's 5-way division of the previous one (the JAX-free counterpart of
    ``aznet_tpu/train/labels.py::division_tree_regions`` without its
    ``min_size`` gate, which head calibration does not use)."""
    table = torch.as_tensor(division_table(div_overlap))
    h, w = float(im_hw[0]), float(im_hw[1])
    current = torch.tensor([[0.0, 0.0, w - offset, h - offset]], dtype=torch.float32)
    out = [current]
    for _ in range(levels):
        current = _apply_normalized(current, table, offset).reshape(-1, 4)
        out.append(current)
    return torch.cat(out).numpy()
