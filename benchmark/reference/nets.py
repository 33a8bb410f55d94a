"""Plain PyTorch reference of the benchmarked networks, in float32: what
every network shares, and the dispatch to the network of a configuration.

A network is a module of its own, ``reference/networks/<network>.py``, found
by its configuration's ``MODEL["BACKBONE"]`` (``network``). It defines, in
plain PyTorch:

- ``param_specs(model, kind)``: every parameter ``[(name, shape, init)]``;
- ``trunk(model, p, x, q)``: ``[B, H, W, 3]`` -> ``[B, H/s, W/s, C]``;
- ``head(model, kind, p, pooled, q)``: the pooled rois ``[R, P, P, C]`` ->
  the output dict (``output_dot``'s);
- ``head_outputs(kind, model)``: the output layers, whose rows the weights'
  draw centres and scales;
- ``head_input_weights(model, kind)``: the weights that take the pooled
  features, which the draw scales by the inverse of the trunk's output rms;
- ``trunk_flops(model, canvas)`` and ``head_flops(model, kind, rows)``: the
  FLOPs of its convolutions and dots;
- ``TINY``: the ``MODEL`` settings a CPU test cuts it to.

Shared here:

- ROI align (He et al., arXiv:1703.06870) at ``POOL_SIZE`` bins, two
  bilinear samples per bin and axis averaged, on the feature map at
  ``1/FEAT_STRIDE`` scale;
- fc6, fc7 (ReLU each) and the output layers (``fc_head``): AZ-Net's zoom
  score, 11 adjacency scores and 44 deltas (arXiv:1512.07711), or Fast
  R-CNN's class scores and per-class box deltas (arXiv:1504.08083), as one
  dot (``output_dot``);
- the convolution, the frozen BatchNorm (``x * scale + bias``) and
  TensorFlow's ``SAME`` padding of stride-2 3x3 convs (the extra row and
  column at the bottom and right), the system's convention;
- the preprocess: BGR pixel means subtracted, a bilinear resize (half-pixel
  centres) by the scale that takes the short side to the target, capped by
  the maximum size, onto a zero-padded canvas.

Tensors are NHWC at the boundaries, as the system's. Parameters are a flat
dict under the system's names (``param_specs``), so the benchmark hands the
same float32 weights to both. Every conv and matmul runs in true float32
(TF32 off, ``ieee_fp32``). ``q``, where given, rounds each operand of a conv
or matmul (weights and activations) before the float32 product: the
lower-precision control of ``reference/lowp.py``.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import math
from pathlib import Path

import torch
import torch.nn.functional as F

NETWORKS_DIR = Path(__file__).resolve().parent / "networks"
FC_HEAD_INPUT = ("head.fc.fc6.weight",)


@contextlib.contextmanager
def ieee_fp32():
    """Float32 convs and matmuls in true float32 (TF32 off), the caller's
    settings restored afterwards."""
    conv, matmul = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    prev = conv.fp32_precision, matmul.fp32_precision
    conv.fp32_precision = matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision, matmul.fp32_precision = prev


def _ident(x):
    return x


# -- networks -----------------------------------------------------------------

@functools.cache
def network_module(name: str):
    """The module ``networks/<name>.py``, loaded once."""
    path = NETWORKS_DIR / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference network {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"_bench_network_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def network(model: dict):
    """The network module of a configuration's ``MODEL`` section, named by
    its ``BACKBONE``."""
    return network_module(model["BACKBONE"])


def param_specs(model: dict, kind: str):
    """Every parameter of the ``kind`` (``'az'`` or ``'frcnn'``) network of a
    config's ``MODEL`` section: ``[(name, shape, init)]``, ``init`` one of
    ``fan_in`` (normal, std 1/sqrt(fan-in)), ``score`` (std 0.01), ``bbox``
    (std 0.001), ``bias`` (std 0.01) and ``bn_scale`` (1 + 0.1 normal)."""
    return network(model).param_specs(model, kind)


def head_outputs(kind: str, model: dict) -> dict:
    """The output layers of the network's head ``{name: (rows, init)}``."""
    return network(model).head_outputs(kind, model)


def head_input_weights(model: dict, kind: str):
    return network(model).head_input_weights(model, kind)


def trunk(model: dict, p: dict, x: torch.Tensor, q=_ident) -> torch.Tensor:
    """The network's trunk, in true float32."""
    with ieee_fp32():
        return network(model).trunk(model, p, x.float(), q)


def head(model: dict, kind: str, p: dict, pooled: torch.Tensor, q=_ident) -> dict:
    """The network's head, in true float32."""
    with ieee_fp32():
        return network(model).head(model, kind, p, pooled, q)


def roi_forward(model: dict, kind: str, p: dict, feat, rois, q=_ident) -> dict:
    pooled = roi_align(q(feat), rois, model["FEAT_STRIDE"], model["POOL_SIZE"])
    return head(model, kind, p, pooled, q)


# -- parameters ---------------------------------------------------------------

def init_std(shape, init: str) -> tuple:
    """``(std, mean)`` of a parameter's normal draw."""
    return {"fan_in": (1.0 / math.sqrt(math.prod(shape[1:]) if len(shape) > 1 else 1.0), 0.0),
            "score": (0.01, 0.0), "bbox": (0.001, 0.0), "bias": (0.01, 0.0),
            "bn_scale": (0.1, 1.0)}[init]


def bn_specs(prefix: str, ch: int):
    return [(f"{prefix}.scale", (ch,), "bn_scale"), (f"{prefix}.bias", (ch,), "bias")]


def output_layers(kind: str, model: dict) -> dict:
    """AZ-Net's or Fast R-CNN's output layers ``{name: (rows, init)}``, in
    the order of ``output_dot``."""
    if kind == "az":
        k = model["NUM_TEMPLATES"]
        return {"zoom_score": (1, "score"), "adj_score": (k, "score"), "adj_bbox": (4 * k, "bbox")}
    c = model["NUM_CLASSES"]
    return {"cls_score": (c, "score"), "bbox_pred": (4 * c, "bbox")}


def output_specs(kind: str, model: dict, in_dim: int):
    out = []
    for name, (rows, init) in output_layers(kind, model).items():
        out += [(f"head.{name}.weight", (rows, in_dim), init), (f"head.{name}.bias", (rows,), "bias")]
    return out


def fc_head_specs(model: dict, kind: str, channels: int):
    """fc6 and fc7 on the flattened ``POOL_SIZE`` x ``POOL_SIZE`` x
    ``channels`` pool, and the output layers."""
    fc_dim = model["FC_DIM"]
    d7 = model["FC7_DIM"] or fc_dim
    in_dim = model["POOL_SIZE"] ** 2 * channels
    return [("head.fc.fc6.weight", (fc_dim, in_dim), "fan_in"), ("head.fc.fc6.bias", (fc_dim,), "bias"),
            ("head.fc.fc7.weight", (d7, fc_dim), "fan_in"), ("head.fc.fc7.bias", (d7,), "bias"),
            *output_specs(kind, model, d7)]


# -- layers ---------------------------------------------------------------------

def conv(x, w, b=None, q=_ident, **kw):
    return F.conv2d(q(x), q(w), b, **kw)


def frozen_bn(p, prefix, x):
    return x * p[f"{prefix}.scale"][:, None, None] + p[f"{prefix}.bias"][:, None, None]


def pad_same(x, k: int, s: int):
    """TensorFlow's ``SAME`` padding of NCHW ``x`` for a k x k / s conv."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


# -- ROI align and heads --------------------------------------------------------

def _bin_weights(lo, size, extent: int, pool: int):
    """``[R, pool, extent]``: per bin, the mean of its two bilinear samples'
    weights on the cells of one axis (samples clipped into the map)."""
    n = 2 * pool
    grid = ((torch.arange(n, dtype=torch.float32) + 0.5) / n).to(lo.device)
    pos = (lo[:, None] + grid[None, :] * size[:, None]).clamp(0.0, extent - 1.0)
    cells = torch.arange(extent, dtype=torch.float32, device=lo.device)
    w = (1.0 - (pos[:, :, None] - cells).abs()).clamp(min=0.0)
    return w.reshape(lo.shape[0], pool, 2, extent).mean(2)


def roi_align(feat, rois, stride: int, pool: int, chunk: int = 32):
    """``feat [H, W, C]`` float32, ``rois [R, 4]`` in image coordinates ->
    ``[R, pool, pool, C]``."""
    h, w, _ = feat.shape
    outs = []
    with ieee_fp32():
        for i in range(0, rois.shape[0], chunk):
            x1, y1, x2, y2 = (rois[i:i + chunk].float() * (1.0 / stride)).unbind(-1)
            wy = _bin_weights(y1, (y2 - y1).clamp(min=1.0), h, pool)
            wx = _bin_weights(x1, (x2 - x1).clamp(min=1.0), w, pool)
            rows = torch.einsum("rph,hwc->rpwc", wy, feat)
            outs.append(torch.einsum("rqw,rpwc->rpqc", wx, rows))
    return torch.cat(outs)


def fc_head(model: dict, kind: str, p: dict, pooled: torch.Tensor, q=_ident) -> dict:
    """fc6 -> ReLU -> fc7 -> ReLU -> the output layers (one dot)."""
    x = pooled.reshape(pooled.shape[0], -1)
    for fc in ("fc6", "fc7"):
        x = F.relu(F.linear(q(x), q(p[f"head.fc.{fc}.weight"]), p[f"head.fc.{fc}.bias"]))
    return output_dot(model, kind, p, x, q)


def output_dot(model: dict, kind: str, p: dict, x: torch.Tensor, q=_ident) -> dict:
    """The output layers of ``output_layers`` as one dot over ``x [R, D]``:
    ``zoom``, ``adj_score``, ``adj_delta [R, K, 4]`` (``'az'``) or
    ``cls_score``, ``bbox_pred`` (``'frcnn'``)."""
    outs = output_layers(kind, model)
    w = torch.cat([p[f"head.{n}.weight"] for n in outs])
    b = torch.cat([p[f"head.{n}.bias"] for n in outs])
    y = F.linear(q(x), q(w), b)
    if kind == "az":
        k = model["NUM_TEMPLATES"]
        return {"zoom": y[:, 0], "adj_score": y[:, 1:1 + k],
                "adj_delta": y[:, 1 + k:].reshape(-1, k, 4)}
    c = model["NUM_CLASSES"]
    return {"cls_score": y[:, :c], "bbox_pred": y[:, c:]}


def dense_flops(specs, rows: int) -> float:
    """Two FLOPs a multiply-add of every dot of ``specs`` (a 2-d
    ``head.*.weight``: fc6, fc7, the output layers) over ``rows`` rows."""
    shapes = {name: shape for name, shape, _ in specs
              if name.startswith("head.") and name.endswith(".weight") and len(shape) == 2}
    return 2.0 * rows * sum(s[0] * s[1] for s in shapes.values())


# -- preprocess -----------------------------------------------------------------

def compute_scale(h: int, w: int, target: int, max_size: int) -> float:
    """The short side to ``target``, unless the long side would pass
    ``max_size``."""
    scale = float(target) / float(min(h, w))
    if round(scale * max(h, w)) > max_size:
        scale = float(max_size) / float(max(h, w))
    return scale


def canvas_for(h: int, w: int, target: int, max_size: int, bucket: int = 64):
    """The system's one-image canvas: the scaled size rounded up to ``bucket``."""
    s = compute_scale(h, w, target, max_size)
    return tuple(int(-(-int(round(v * s)) // bucket) * bucket) for v in (h, w))


def preprocess(im, means, scale: float, out_h: int, out_w: int):
    """Raw ``im [H, W, 3]`` (uint8 BGR) -> ``(canvas [out_h, out_w, 3]
    float32, valid_h, valid_w)``, the extents float32 0-d tensors: the means
    subtracted, then a bilinear resize by ``scale`` as two separable
    triangle-weight matmuls, zero past the scaled extent."""
    dev = im.device
    hp, wp, c = im.shape
    s = torch.tensor(scale, dtype=torch.float32, device=dev)
    x = im.float() - torch.tensor(means, dtype=torch.float32, device=dev)
    vh = torch.round(torch.tensor(float(hp), device=dev) * s)
    vw = torch.round(torch.tensor(float(wp), device=dev) * s)

    def weights(n_out, n_src, valid):
        pos = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) / s - 0.5
        pos = torch.minimum(pos.clamp(min=0.0), torch.tensor(n_src - 1.0, device=dev))
        cells = torch.arange(n_src, dtype=torch.float32, device=dev)
        wt = (1.0 - (pos[:, None] - cells).abs()).clamp(min=0.0)
        return wt * (torch.arange(n_out, device=dev)[:, None] < valid)

    with ieee_fp32():
        rows = weights(out_h, hp, vh) @ x.reshape(hp, wp * c)
        rows = rows.reshape(out_h, wp, c).permute(1, 0, 2).reshape(wp, out_h * c)
        out = (weights(out_w, wp, vw) @ rows).reshape(out_w, out_h, c).permute(1, 0, 2)
    return out.contiguous(), vh, vw
