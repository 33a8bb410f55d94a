"""Backbone factory keyed on ``cfg.MODEL.BACKBONE``
(``aznet_tpu/models/backbones.py``)."""

from __future__ import annotations

import torch

from aznet_tpu_torch.config import ModelConfig
from aznet_tpu_torch.models.fpn import ResNet101FPNTrunk
from aznet_tpu_torch.models.resnet import ResNet50Trunk, ResNet101Trunk
from aznet_tpu_torch.models.small import CaffeNetTrunk, SmallTrunk, VGGCNNM1024Trunk
from aznet_tpu_torch.models.vgg import VGG16Trunk

BACKBONES = {
    "vgg16": VGG16Trunk,
    "resnet50": ResNet50Trunk,
    # ResNet-101 to conv4_x; its heads run conv5_x on each pooled roi (the
    # C4 detector; MODEL.POOL_SIZE 14).
    "resnet101_c4": ResNet101Trunk,
    # ResNet-101 and an FPN: a tuple of four levels, P2 to P5, each box pooled
    # from its own (Faster R-CNN R-101-FPN; MODEL.POOL_SIZE 7, FC_DIM 1024).
    "resnet101_fpn": ResNet101FPNTrunk,
    "smallnet": SmallTrunk,
    # The reference fork's smaller nets: pair them with MODEL.POOL_SIZE 6,
    # vgg_cnn_m_1024 also with MODEL.FC7_DIM 1024.
    "caffenet": CaffeNetTrunk,
    "vgg_cnn_m_1024": VGGCNNM1024Trunk,
}


def get_backbone(model_cfg: ModelConfig):
    """The trunk module for a MODEL config, computing in
    :func:`compute_dtype`. Int8 (``COMPUTE_DTYPE='int8'``) exists for vgg16
    and resnet50 only, as in the reference (``models/aznet.py::check_supported``
    refuses it for resnet101_c4 and resnet101_fpn first); ``FUSE_CONV1`` reaches the VGG-16
    trunk's float path."""
    try:
        cls = BACKBONES[model_cfg.BACKBONE]
    except KeyError:
        raise ValueError(f"unknown backbone {model_cfg.BACKBONE!r}; "
                         f"options: {sorted(BACKBONES)}") from None
    int8_mode = model_cfg.COMPUTE_DTYPE == "int8"
    dtype = compute_dtype(model_cfg)
    if cls is VGG16Trunk:
        return cls(width=model_cfg.WIDTH, int8_mode=int8_mode,
                   int8_scales=tuple(model_cfg.INT8_SCALES),
                   int8_backend=model_cfg.INT8_BACKEND,
                   int8_chain_from=model_cfg.INT8_CHAIN_FROM,
                   fuse_conv1=model_cfg.FUSE_CONV1, dtype=dtype)
    if issubclass(cls, ResNet50Trunk):
        return cls(int8_mode=int8_mode, int8_scales=tuple(model_cfg.INT8_SCALES), dtype=dtype)
    if int8_mode:
        raise ValueError(f"COMPUTE_DTYPE='int8' is only implemented for the vgg16 and "
                         f"resnet50 backbones, not {model_cfg.BACKBONE!r}")
    return cls(dtype=dtype)


def compute_dtype(model_cfg: ModelConfig) -> torch.dtype:
    """float32 for ``COMPUTE_DTYPE='float32'``, else bf16 (the int8 nets'
    float layers compute in bf16)."""
    return torch.float32 if model_cfg.COMPUTE_DTYPE == "float32" else torch.bfloat16
