"""Backbone factory keyed on ``cfg.MODEL.BACKBONE`` (vgg16 and smallnet)."""

from __future__ import annotations

from aznet_tpu_torch.config import ModelConfig
from aznet_tpu_torch.models.small import SmallTrunk
from aznet_tpu_torch.models.vgg import VGG16Trunk

BACKBONES = ("vgg16", "smallnet")


def get_backbone(model_cfg: ModelConfig):
    """The trunk module for a MODEL config; the int8 fields reach the VGG-16
    trunk when ``COMPUTE_DTYPE='int8'``, ``FUSE_CONV1`` its float path."""
    if model_cfg.BACKBONE == "vgg16":
        return VGG16Trunk(width=model_cfg.WIDTH,
                          int8_mode=model_cfg.COMPUTE_DTYPE == "int8",
                          int8_scales=tuple(model_cfg.INT8_SCALES),
                          int8_backend=model_cfg.INT8_BACKEND,
                          int8_chain_from=model_cfg.INT8_CHAIN_FROM,
                          fuse_conv1=model_cfg.FUSE_CONV1)
    if model_cfg.BACKBONE == "smallnet":
        return SmallTrunk()
    raise ValueError(f"backbone {model_cfg.BACKBONE!r} is not ported; options: {BACKBONES}")
