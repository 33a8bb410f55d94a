"""Caffe weights -> the port's state dict (counterpart of
``aznet_tpu/utils/convert_weights.py``).

Caffe snapshots (``.caffemodel``) are extracted to ``.npz`` wherever pycaffe
exists (``{layer}_W``, ``{layer}_b``); conversion is NumPy and torch only:

- conv: Caffe's ``(out, in, kh, kw)`` already is a torch OIHW weight,
  grouped kernels ``(out, in / g, kh, kw)`` included;
- Dense: Caffe's ``(out, in)`` already is a ``Linear`` weight;
- fc6 is the one permutation: Caffe flattens ROI-pooled features channel
  first, input ``c * P * P + ph * P + pw``, while the port pools into NHWC
  and flattens ``ph * P * C + pw * C + c``.

Caffe nets take BGR input, as the port does, so conv1 converts unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

Caffe = Dict[str, Tuple[np.ndarray, np.ndarray]]


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def convert_layer(w: np.ndarray, b: np.ndarray, prefix: str) -> dict:
    """A conv or Dense layer: the arrays as they are, named ``prefix.weight``
    and ``prefix.bias``."""
    return {f"{prefix}.weight": _tensor(w), f"{prefix}.bias": _tensor(b)}


def convert_fc6(w: np.ndarray, b: np.ndarray, pool: int, channels: int,
                prefix: str = "head.fc.fc6") -> dict:
    """fc6 with its input columns permuted from Caffe's ``(C, P, P)`` flatten
    to the port's ``(P, P, C)``."""
    out_dim = w.shape[0]
    w = np.asarray(w).reshape(out_dim, channels, pool, pool).transpose(0, 2, 3, 1)
    return convert_layer(w.reshape(out_dim, pool * pool * channels), b, prefix)


VGG16_CONV_NAMES = (
    "conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2",
    "conv3_3", "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2",
    "conv5_3",
)
SMALL_TRUNK_CONV_NAMES = ("conv1", "conv2", "conv3", "conv4", "conv5")

_TRUNK_LAYOUTS = {
    # arch -> (conv names, conv5 channels, roi pool size)
    "vgg16": (VGG16_CONV_NAMES, 512, 7),
    "caffenet": (SMALL_TRUNK_CONV_NAMES, 256, 6),
    "vgg_cnn_m_1024": (SMALL_TRUNK_CONV_NAMES, 512, 6),
}


def convert_trunk(caffe_params: Caffe, arch: str = "vgg16") -> dict:
    """``{name: (W, b)}`` -> the ``trunk.*`` entries of the named backbone."""
    out = {}
    for name in _TRUNK_LAYOUTS[arch][0]:
        if name not in caffe_params:
            raise KeyError(f"missing conv layer {name!r} in caffe params")
        out.update(convert_layer(*caffe_params[name], f"trunk.{name}"))
    return out


def _fc(caffe_params: Caffe, pool: int, channels: int) -> dict:
    return {**convert_fc6(*caffe_params["fc6"], pool=pool, channels=channels),
            **convert_layer(*caffe_params["fc7"], "head.fc.fc7")}


def convert_az_head(caffe_params: Caffe, pool: int = 7, channels: int = 512,
                    name_map: Optional[Dict[str, str]] = None) -> dict:
    """fc6/fc7 and the AZ head's layers -> ``head.*`` entries. ``name_map``
    maps the port's head names (``zoom_score``, ``adj_score``, ``adj_bbox``)
    to the prototxt's layer names."""
    name_map = name_map or {"zoom_score": "zoom_score", "adj_score": "adj_score",
                            "adj_bbox": "adj_bbox"}
    out = _fc(caffe_params, pool, channels)
    for ours, theirs in name_map.items():
        out.update(convert_layer(*caffe_params[theirs], f"head.{ours}"))
    return out


def convert_frcnn_head(caffe_params: Caffe, pool: int = 7, channels: int = 512) -> dict:
    """fc6/fc7, ``cls_score`` and ``bbox_pred`` -> ``head.*`` entries."""
    out = _fc(caffe_params, pool, channels)
    for name in ("cls_score", "bbox_pred"):
        out.update(convert_layer(*caffe_params[name], f"head.{name}"))
    return out


def load_npz(path: str) -> Caffe:
    """``{name_W, name_b}`` arrays saved by an extraction script ->
    ``{name: (W, b)}``."""
    with np.load(path) as data:
        names = sorted({k[:-2] for k in data.files if k.endswith("_W")})
        return {n: (data[f"{n}_W"], data[f"{n}_b"]) for n in names}


def convert_npz_to_checkpoint(npz_path: str, out_dir: str, arch: str = "vgg16",
                              pool: Optional[int] = None, channels: Optional[int] = None,
                              backbone: str = "vgg16") -> dict:
    """Caffe ``.npz`` -> a params-only snapshot ``{"params": state_dict}``
    at step 0 in ``out_dir`` (``utils/checkpoint.py``). ``arch``: a trunk
    name (``'vgg16'``, ``'caffenet'``, ``'vgg_cnn_m_1024'``: the trunk only,
    a warm start), ``'az'`` or ``'frcnn'`` (trunk and head, the trunk's
    layout from ``backbone``). Head layers absent from the npz are left out.
    Returns the state dict."""
    from aznet_tpu_torch.utils.checkpoint import Checkpointer

    if arch in _TRUNK_LAYOUTS:
        backbone, arch = arch, "trunk"
    _, def_ch, def_pool = _TRUNK_LAYOUTS[backbone]
    pool = def_pool if pool is None else pool
    channels = def_ch if channels is None else channels
    caffe = load_npz(npz_path)
    params = convert_trunk(caffe, backbone)
    if arch == "az" and "fc6" in caffe:
        params.update(convert_az_head(caffe, pool=pool, channels=channels))
    elif arch == "frcnn" and "fc6" in caffe:
        params.update(convert_frcnn_head(caffe, pool=pool, channels=channels))
    Checkpointer(out_dir).save(0, {"params": params})
    return params
