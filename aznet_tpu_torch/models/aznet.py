"""AZ-Net: trunk + ROI pooling + AZ head (``aznet_tpu/models/aznet.py``),
and the base it shares with the Fast R-CNN detector (``models/frcnn.py``).

The trunk runs once per batch; ``roi_forward(feat, rois)`` is a plain
function of one image's features, called by the search at every level.
"""

from __future__ import annotations

import math
import warnings

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from aznet_tpu_torch.config import ModelConfig
from aznet_tpu_torch.models.backbones import BACKBONES, compute_dtype, get_backbone
from aznet_tpu_torch.models.heads import AZHead
from aznet_tpu_torch.models.resnet import FrozenBN, ResNet50Trunk
from aznet_tpu_torch.models.vgg import VGG16Trunk
from aznet_tpu_torch.ops.roi_pool import (POOLING_MODES, PYRAMID_MODES, roi_pool,
                                          roi_pool_levels)
from aznet_tpu_torch.utils import profiling


def check_supported(mc: ModelConfig, search_head: bool = False) -> None:
    """Raise on MODEL settings this port does not implement; warn once for
    ``CONV1_S2D`` (VGG-16) and ``STEM_S2D`` (the ResNets), whose
    space-to-depth rewrites are term-identical to the plain convs.
    ``search_head``: the net is AZ-Net's.

    The backbone factory raises on int8 for a trunk other than vgg16 and
    resnet50, as the reference's; the VGG trunk checks its own int8
    settings (``models/vgg.py``). A conv5_x head (a trunk class's
    ``conv5_head``) has no int8 form: ``COMPUTE_DTYPE='int8'`` and
    ``INT8_HEAD_SCALES`` raise here, naming the backbone. A feature pyramid
    (a trunk class's ``level_strides``) runs only the Fast R-CNN head, in
    float, pooled by ``'align_pallas'`` or ``'align'``: AZ-Net's search head
    (so the fused detect too), ``COMPUTE_DTYPE='int8'``,
    ``INT8_HEAD_SCALES``, ``INT8_ROI`` and any other pooling raise here,
    naming the backbone; its trunk refuses a mesh split over ``model``
    (``models/fpn.py``) and the train step the pyramid
    (``train/train_az.py::head_outputs``)."""
    if mc.COMPUTE_DTYPE not in ("float32", "bfloat16", "int8"):
        raise NotImplementedError(f"COMPUTE_DTYPE={mc.COMPUTE_DTYPE!r} is not ported")
    if mc.POOLING_MODE not in POOLING_MODES:
        raise ValueError(f"unknown POOLING_MODE {mc.POOLING_MODE!r}; options: {POOLING_MODES}")
    trunk = BACKBONES.get(mc.BACKBONE, nn.Module)  # get_backbone refuses an unknown name
    if getattr(trunk, "conv5_head", False) and (mc.COMPUTE_DTYPE == "int8"
                                                 or mc.INT8_HEAD_SCALES):
        raise NotImplementedError(f"backbone {mc.BACKBONE!r}: its conv5_x head has no int8 form "
                                  "(COMPUTE_DTYPE='int8', INT8_HEAD_SCALES)")
    if getattr(trunk, "level_strides", None):
        for what, refused in (("AZ-Net's search head", search_head),
                              ("int8 form (COMPUTE_DTYPE='int8')", mc.COMPUTE_DTYPE == "int8"),
                              ("int8 form (INT8_HEAD_SCALES)", bool(mc.INT8_HEAD_SCALES)),
                              ("int8 form (INT8_ROI)", mc.INT8_ROI),
                              (f"POOLING_MODE {mc.POOLING_MODE!r}",
                               mc.POOLING_MODE not in PYRAMID_MODES)):
            if refused:
                raise NotImplementedError(f"backbone {mc.BACKBONE!r}: its feature pyramid has "
                                          f"no {what}")
    if mc.CONV1_S2D and mc.BACKBONE == "vgg16":
        warnings.warn("MODEL.CONV1_S2D is ignored: the plain conv1_1 computes "
                      "the same function", stacklevel=3)
    if mc.STEM_S2D and issubclass(trunk, ResNet50Trunk):
        warnings.warn("MODEL.STEM_S2D is ignored: the plain 7x7/2 stem computes "
                      "the same function", stacklevel=3)


class RoiNet(nn.Module):
    """Trunk + ROI pooling + a head (what ``AZNet`` and ``FRCNN`` share).

    - ``features(images [B, H, W, 3])`` -> ``[B, H/16, W/16, C]``, or a
      feature pyramid's levels ``[B, h_l, w_l, C]``, finest first (a trunk
      with ``level_strides``)
    - ``roi_forward(feat, rois [R, 4])`` -> the head's outputs dict, ``feat``
      one image's map ``[h, w, C]`` or its levels

    ``train=True`` (with a ``torch.Generator`` for the dropout masks) selects
    the heads' training branch."""

    search_head = False  # AZ-Net's

    def __init__(self, model_cfg: ModelConfig):
        super().__init__()
        check_supported(model_cfg, self.search_head)
        self.model_cfg = model_cfg
        self.trunk = get_backbone(model_cfg)
        # The heads quantize independently of the trunk (the reference's rule):
        # INT8_HEAD_SCALES alone selects the int8 fc stack, except in float32.
        self.head_scales = (tuple(model_cfg.INT8_HEAD_SCALES)
                            if model_cfg.COMPUTE_DTYPE != "float32" else ())
        # A conv5_x head takes the pools' channels, fc6 the flattened pool.
        self.conv5 = getattr(self.trunk, "conv5_head", False)
        self.pooled_dim = (self.trunk.out_channels if self.conv5
                           else model_cfg.POOL_SIZE ** 2 * self.trunk.out_channels)

    def features(self, images: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """``remat`` recomputes the trunk's activations in the backward pass
        instead of keeping them (``TRAIN.REMAT_TRUNK``): VGG-16 layer by
        layer, the other trunks as one ``torch.utils.checkpoint`` region."""
        if not remat:
            return self.trunk(images)
        if isinstance(self.trunk, VGG16Trunk):
            return self.trunk(images, remat=True)
        return checkpoint(self.trunk, images, use_reentrant=False)

    def prepare_int8(self) -> None:
        """Quantize the int8 layers' weights once, from the parameters as they
        are now: call after loading weights and casting (the int8 trunk reads
        float32 weights, the int8 fc stack the bf16-rounded ones)."""
        if getattr(self.trunk, "int8_mode", False):
            self.trunk.prepare_int8()
        if self.head.fc.int8_scales:
            self.head.fc.prepare_int8()

    def roi_pool_only(self, feat, rois: torch.Tensor) -> torch.Tensor:
        """``[R, P, P, C]`` pools of ``rois`` on one image's features: its map
        at ``1 / FEAT_STRIDE``, or, for a sequence of levels, each roi from
        its own level at the trunk's ``level_strides`` (a ``heads.pool``
        span, ``rows`` the rois)."""
        mc = self.model_cfg
        if isinstance(feat, torch.Tensor):
            return roi_pool(feat, rois, 1.0 / mc.FEAT_STRIDE, mc.POOL_SIZE, mode=mc.POOLING_MODE)
        with profiling.span("heads.pool", rows=rois.shape[0]):
            return roi_pool_levels(feat, rois, self.trunk.level_strides, mc.POOL_SIZE,
                                   mode=mc.POOLING_MODE)

    def head_forward(self, pooled: torch.Tensor, train: bool = False,
                     generator: torch.Generator | None = None) -> dict:
        return self.head(pooled, train, generator)

    def roi_forward(self, feat: torch.Tensor, rois: torch.Tensor, train: bool = False,
                    generator: torch.Generator | None = None) -> dict:
        return self.head(self.roi_pool_only(feat, rois), train, generator)

    def head_kwargs(self) -> dict:
        """The head settings of the config that both heads take (a conv5_x
        head reads none of fc6/fc7's)."""
        mc = self.model_cfg
        return {"fc_dim": mc.FC_DIM, "fc7_dim": mc.FC7_DIM, "int8_scales": self.head_scales,
                "dropout": mc.DROPOUT, "dtype": compute_dtype(mc), "conv5": self.conv5}


class AZNet(RoiNet):
    """Zoom/adjacency proposal network: ``roi_forward`` returns ``zoom [R]``,
    ``adj_score [R, K]`` and ``adj_delta [R, K, 4]``."""

    search_head = True

    def __init__(self, model_cfg: ModelConfig = ModelConfig()):
        super().__init__(model_cfg)
        self.head = AZHead(self.pooled_dim, model_cfg.NUM_TEMPLATES, **self.head_kwargs())


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with the Flax initialisers of the same layers:
    lecun-normal kernels (truncated at 2 sigma, fan-in), zero biases,
    normal(0.01) / normal(0.001) for the heads' score / box layers (each
    head's ``SCORE_STD``), and the identity for ``FrozenBN`` (scale 1, bias
    0)."""
    std_of = {}
    for mod in model.modules():
        for name, std in getattr(mod, "SCORE_STD", {}).items():
            std_of[getattr(mod, name)] = std
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, FrozenBN):
                nn.init.ones_(mod.scale)
                nn.init.zeros_(mod.bias)
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
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
