"""Backbone factory keyed on ``cfg.MODEL.BACKBONE`` (vgg16 and smallnet)."""

from __future__ import annotations

from aznet_tpu.config import ModelConfig
from aznet_tpu_torch.models.small import SmallTrunk
from aznet_tpu_torch.models.vgg import VGG16Trunk

BACKBONES = ("vgg16", "smallnet")


def get_backbone(model_cfg: ModelConfig):
    """The trunk module for a MODEL config."""
    if model_cfg.BACKBONE == "vgg16":
        return VGG16Trunk(width=model_cfg.WIDTH)
    if model_cfg.BACKBONE == "smallnet":
        return SmallTrunk()
    raise ValueError(f"backbone {model_cfg.BACKBONE!r} is not ported; options: {BACKBONES}")
