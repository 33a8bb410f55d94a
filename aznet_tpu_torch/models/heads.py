"""AZ head: fc6/fc7 + zoom/adjacency outputs (inference path of
``aznet_tpu/models/heads.py``: ``_FCStack`` float path and ``AZHead``).

Layer names match the reference's parameter tree (``fc.fc6``, ``fc.fc7``,
``zoom_score``, ``adj_score``, ``adj_bbox``) so converted weights load 1:1.
Dropout is identity at inference and is not part of this port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FCStack(nn.Module):
    """fc6 -> ReLU -> fc7 -> ReLU on flattened NHWC pooled features."""

    def __init__(self, in_dim: int, fc_dim: int = 4096, fc7_dim: int = 0):
        super().__init__()
        self.fc6 = nn.Linear(in_dim, fc_dim)
        self.fc7 = nn.Linear(fc_dim, fc7_dim or fc_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.fc6.weight.dtype)
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class AZHead(nn.Module):
    """``[R, P, P, C]`` pooled features -> ``zoom [R]``, ``adj_score [R, K]``
    (logits) and ``adj_delta [R, K, 4]``, all float32."""

    SCORE_STD = {"zoom_score": 0.01, "adj_score": 0.01, "adj_bbox": 0.001}

    def __init__(self, in_dim: int, num_templates: int = 11, fc_dim: int = 4096,
                 fc7_dim: int = 0):
        super().__init__()
        self.num_templates = num_templates
        self.fc = FCStack(in_dim, fc_dim, fc7_dim)
        d = fc7_dim or fc_dim
        self.zoom_score = nn.Linear(d, 1)
        self.adj_score = nn.Linear(d, num_templates)
        self.adj_bbox = nn.Linear(d, 4 * num_templates)

    def forward(self, pooled: torch.Tensor) -> dict:
        k = self.num_templates
        x = self.fc(pooled)
        # ONE f32 dot against the three output layers, on the weights as
        # stored (bf16-rounded in bf16 mode): the reference's _fused_heads.
        layers = (self.zoom_score, self.adj_score, self.adj_bbox)
        w = torch.cat([m.weight for m in layers]).float()
        b = torch.cat([m.bias for m in layers]).float()
        y = x.float() @ w.t() + b
        return {
            "zoom": y[:, 0],
            "adj_score": y[:, 1:1 + k],
            "adj_delta": y[:, 1 + k:].reshape(-1, k, 4),
        }
