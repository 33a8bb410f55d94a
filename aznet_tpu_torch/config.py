"""Configuration tree of the port: a copy of ``aznet_tpu/config.py``.

The same frozen dataclasses, field names and defaults as the JAX package's
tree, so a config written for one runs the other (``tests/test_torch_detect.py``
holds the two default trees equal). Overrides merge with type checking
against the defaults: ``cfg_from_dict``, ``cfg_from_list`` (``KEY VALUE``
pairs with dotted keys) and ``cfg_from_file`` (YAML, imported only when
called). The tree is immutable: an override returns a new ``Config``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Tuple


@dataclass(frozen=True)
class SearchConfig:
    """Adjacency-and-zoom search (``cfg.SEAR``)."""

    # Zoom indicator threshold: regions with z > ZOOM_THRESH are subdivided.
    ZOOM_THRESH: float = 0.2
    # Adjacency confidence threshold: candidates below it are dropped.
    CONF_THRESH: float = 0.05
    # Maximum search-tree depth.
    MAX_LEVELS: int = 6
    # Regions whose shorter side is below this (pixels) are not subdivided.
    MIN_SIZE: float = 16.0
    # Per-level frontier capacity (padded frontier).
    FRONTIER_CAP: int = 64
    # Candidate buffer size (top-K by score).
    CAND_BUF: int = 2048
    # Proposals returned per image.
    NUM_PROPOSALS: int = 300
    # NMS IoU threshold over the accumulated candidates.
    NMS_THRESH: float = 0.7
    # Extra relative overlap of the 5 zoom sub-regions.
    DIV_OVERLAP: float = 0.0
    # Division levels seeded into the first frontier beside the whole image.
    SEED_LEVELS: int = 1
    # Clip of |dw|, |dh| in delta decoding (log(1000/16)).
    BBOX_XFORM_CLIP: float = 4.135166556742356


@dataclass(frozen=True)
class TrainConfig:
    """Training (``cfg.TRAIN``)."""

    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    IMS_PER_BATCH: int = 2
    BATCH_SIZE: int = 128
    FG_FRACTION: float = 0.25
    FG_THRESH: float = 0.5
    BG_THRESH_HI: float = 0.5
    BG_THRESH_LO: float = 0.1
    USE_FLIPPED: bool = True
    BBOX_NORMALIZE_TARGETS: bool = True
    BBOX_NORMALIZE_MEANS: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    BBOX_NORMALIZE_STDS: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    BBOX_THRESH: float = 0.5
    ZOOM_CONTAIN_THRESH: float = 0.5
    ZOOM_AREA_FRAC: float = 0.25
    ADJ_FG_THRESH: float = 0.5
    ADJ_POS_WEIGHT: float = 1.0
    ZOOM_POS_WEIGHT: float = 1.0
    REGIONS_PER_IMAGE: int = 128
    MINE_INTERVAL: int = 0
    MINE_IMAGES: int = 32
    LEARNING_RATE: float = 0.001
    MOMENTUM: float = 0.9
    WEIGHT_DECAY: float = 0.0005
    STEPSIZE: int = 30000
    GAMMA: float = 0.1
    MAX_ITERS: int = 40000
    SNAPSHOT_ITERS: int = 10000
    SNAPSHOT_PREFIX: str = "aznet"
    GRAD_CLIP: float = 0.0
    REMAT_TRUNK: bool = False
    NUM_WORKERS: int = 1
    FREEZE_PREFIXES: Tuple[str, ...] = ()


@dataclass(frozen=True)
class TestConfig:
    """Inference (``cfg.TEST``)."""

    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    # Detection NMS and score thresholds, detections kept per image.
    NMS: float = 0.3
    SCORE_THRESH: float = 0.05
    MAX_PER_IMAGE: int = 100
    SIZE_MULTIPLE: int = 32
    # Passes through the detection head (1 = one decode); each further pass
    # re-pools every roi at its best foreground class's decoded box.
    BBOX_ITER: int = 1


@dataclass(frozen=True)
class ModelConfig:
    """Network architecture (``cfg.MODEL``)."""

    # vgg16 | resnet50 | caffenet | vgg_cnn_m_1024 | smallnet
    BACKBONE: str = "vgg16"
    # Channel-width multiplier (1.0 = the published architecture).
    WIDTH: float = 1.0
    FEAT_STRIDE: int = 16
    POOL_SIZE: int = 7
    # "align" | "align_pallas" (the fused ROI-align kernel) | "caffe_max"
    POOLING_MODE: str = "align"
    NUM_TEMPLATES: int = 11
    # Detection classes (VOC: 20 + background).
    NUM_CLASSES: int = 21
    FC_DIM: int = 4096
    # fc7 width when it differs from fc6; 0 = FC_DIM.
    FC7_DIM: int = 0
    DROPOUT: float = 0.5
    # "float32" | "bfloat16" | "int8" (inference, vgg16 or resnet50; needs INT8_SCALES).
    COMPUTE_DTYPE: str = "bfloat16"
    # Activation scales of the int8 trunk: vgg16 conv1_1..conv5_3; resnet50
    # two per bottleneck (block input, mid), then the trunk output's.
    INT8_SCALES: Tuple[float, ...] = ()
    # (pooled-input scale, fc6-output scale) of the int8 fc6/fc7.
    INT8_HEAD_SCALES: Tuple[float, ...] = ()
    # Int8 trunk conv backend: "pallas" | "pallas_strip" | "xla".
    INT8_BACKEND: str = "pallas"
    # First int8 layer of the "pallas" backend: "conv2_2" | "conv1_2".
    INT8_CHAIN_FROM: str = "conv2_2"
    # Quantize the trunk output once so ROI align and fc6 run on int8.
    INT8_ROI: bool = False
    # ResNet stem as its space-to-depth rewrite (same function).
    STEM_S2D: bool = True
    # VGG conv1_1 as its space-to-depth rewrite (same function).
    CONV1_S2D: bool = False
    # Inference: conv1_2 + ReLU + pool1 of VGG-16 as one fused kernel.
    FUSE_CONV1: bool = False


@dataclass(frozen=True)
class Config:
    """Root config."""

    SEAR: SearchConfig = field(default_factory=SearchConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    # BGR pixel means (the Caffe constants).
    PIXEL_MEANS: Tuple[float, float, float] = (102.9801, 115.9465, 122.7717)
    RNG_SEED: int = 3
    EXP_DIR: str = "default"
    OUTPUT_DIR: str = "output"
    # Box convention: 1.0 = "+1" widths (Caffe), 0.0 = half-open.
    BOX_OFFSET: float = 1.0


def _coerce(value: Any, template: Any, path: str) -> Any:
    """``value`` as the type of ``template``; raises on a mismatch."""
    if is_dataclass(template):
        if not isinstance(value, dict):
            raise TypeError(f"{path}: expected mapping for {type(template).__name__}")
        return _merge_dataclass(template, value, path)
    t = type(template)
    if t is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if t is int:
        if isinstance(value, float) and value != int(value):
            raise TypeError(f"{path}: expected int, got {value!r}")
        return int(value)
    if t is float:
        return float(value)
    if t is str:
        return str(value)
    if t is tuple:
        if not isinstance(value, (list, tuple)):
            raise TypeError(f"{path}: expected sequence, got {value!r}")
        if len(template):
            return tuple(type(template[0])(v) for v in value)
        return tuple(value)
    raise TypeError(f"{path}: unsupported config type {t}")


def _merge_dataclass(base: Any, overrides: dict, path: str = "") -> Any:
    valid = {f.name for f in fields(base)}
    updates = {}
    for key, value in overrides.items():
        if key not in valid:
            raise KeyError(f"unknown config key: {path + key!r}")
        updates[key] = _coerce(value, getattr(base, key), path + key)
    return dataclasses.replace(base, **updates)


def cfg_from_dict(cfg: Config, overrides: dict) -> Config:
    """Deep-merge a nested dict of overrides into ``cfg`` (type-checked)."""
    return _merge_dataclass(cfg, overrides)


def cfg_from_file(cfg: Config, filename: str) -> Config:
    """Merge a YAML file into ``cfg``."""
    import yaml

    with open(filename) as f:
        data = yaml.safe_load(f) or {}
    return cfg_from_dict(cfg, data)


def cfg_from_list(cfg: Config, args: list) -> Config:
    """Apply ``[KEY, VALUE, ...]`` overrides with dotted keys
    (``SEAR.NUM_PROPOSALS 300``); values parse as Python literals where
    they can."""
    import ast

    if len(args) % 2 != 0:
        raise ValueError("cfg_from_list expects an even-length KEY VALUE list")
    nested: dict = {}
    for key, raw in zip(args[0::2], args[1::2]):
        try:
            value = ast.literal_eval(raw) if isinstance(raw, str) else raw
        except (ValueError, SyntaxError):
            value = raw
        node = nested
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return cfg_from_dict(cfg, nested)


def cfg_to_dict(cfg: Any) -> dict:
    """Dataclass tree -> plain nested dict."""
    return {f.name: cfg_to_dict(v) if is_dataclass(v := getattr(cfg, f.name)) else v
            for f in fields(cfg)}


def get_output_dir(cfg: Config, imdb_name: str, net_name: str | None = None) -> str:
    """``OUTPUT_DIR/EXP_DIR/imdb_name[/net_name]``, created (the reference's
    ``get_output_dir``)."""
    parts = [cfg.OUTPUT_DIR, cfg.EXP_DIR, imdb_name] + ([net_name] if net_name else [])
    path = os.path.join(*parts)
    os.makedirs(path, exist_ok=True)
    return path
