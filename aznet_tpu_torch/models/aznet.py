"""AZ-Net: trunk + ROI align + AZ head (``aznet_tpu/models/aznet.py``).

The trunk runs once per batch; ``roi_forward(feat, rois)`` is a plain
function of one image's features, called by the search at every level.
"""

from __future__ import annotations

import math
import warnings

import torch
from torch import nn

from aznet_tpu.config import ModelConfig
from aznet_tpu_torch.models.backbones import get_backbone
from aznet_tpu_torch.models.heads import AZHead
from aznet_tpu_torch.ops.roi_pool import roi_pool

_INT8_FIELDS = ("INT8_SCALES", "INT8_HEAD_SCALES", "INT8_BACKEND",
                "INT8_CHAIN_FROM", "INT8_ROI")


def check_supported(mc: ModelConfig) -> None:
    """Raise on MODEL settings this port does not implement; warn once for
    ``CONV1_S2D``, whose rewrite is term-identical to the plain conv1_1."""
    default = ModelConfig()
    if mc.COMPUTE_DTYPE not in ("float32", "bfloat16"):
        raise NotImplementedError(f"COMPUTE_DTYPE={mc.COMPUTE_DTYPE!r} is not ported")
    changed = [f for f in _INT8_FIELDS if getattr(mc, f) != getattr(default, f)]
    if changed:
        raise NotImplementedError(f"int8 settings are not ported: {changed}")
    if mc.FUSE_CONV1:
        raise NotImplementedError("FUSE_CONV1=True is not ported")
    if mc.POOLING_MODE != "align":
        raise NotImplementedError(f"POOLING_MODE={mc.POOLING_MODE!r} is not ported")
    if mc.CONV1_S2D:
        warnings.warn("MODEL.CONV1_S2D is ignored: the plain conv1_1 computes "
                      "the same function", stacklevel=3)


class AZNet(nn.Module):
    """Zoom/adjacency proposal network.

    - ``features(images [B, H, W, 3])`` -> ``[B, H/16, W/16, C]``
    - ``roi_forward(feat [h, w, C], rois [R, 4])`` -> head outputs dict
    """

    def __init__(self, model_cfg: ModelConfig = ModelConfig()):
        super().__init__()
        check_supported(model_cfg)
        self.model_cfg = model_cfg
        self.trunk = get_backbone(model_cfg)
        p = model_cfg.POOL_SIZE
        self.head = AZHead(p * p * self.trunk.out_channels, model_cfg.NUM_TEMPLATES,
                           model_cfg.FC_DIM, model_cfg.FC7_DIM)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        return self.trunk(images)

    def roi_pool_only(self, feat: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        mc = self.model_cfg
        return roi_pool(feat, rois, 1.0 / mc.FEAT_STRIDE, mc.POOL_SIZE, mode=mc.POOLING_MODE)

    def head_forward(self, pooled: torch.Tensor) -> dict:
        return self.head(pooled)

    def roi_forward(self, feat: torch.Tensor, rois: torch.Tensor) -> dict:
        return self.head(self.roi_pool_only(feat, rois))


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with the Flax initialisers of the same layers:
    lecun-normal kernels (truncated at 2 sigma, fan-in), zero biases, and
    normal(0.01) / normal(0.001) for the AZ head's score / box layers."""
    std_of = {}
    for mod in model.modules():
        if isinstance(mod, AZHead):
            std_of.update({getattr(mod, n): s for n, s in AZHead.SCORE_STD.items()})
    with torch.no_grad():
        for mod in model.modules():
            if not isinstance(mod, (nn.Conv2d, nn.Linear)):
                continue
            if mod in std_of:
                nn.init.normal_(mod.weight, 0.0, std_of[mod], generator=generator)
            else:
                fan_in = mod.weight[0].numel()
                # Flax's truncated_normal variance scaling divides the std by
                # the std of a unit normal truncated to [-2, 2].
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            nn.init.zeros_(mod.bias)
