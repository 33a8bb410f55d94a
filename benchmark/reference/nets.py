"""Plain PyTorch reference of the benchmarked networks, in float32.

- VGG-16 configuration D to conv5_3 (arXiv:1409.1556): thirteen 3x3 convs
  with ReLU, four 2x2/2 max pools, stride 16.
- ResNet-50 to its conv4_x stage (arXiv:1512.03385): the 7x7/2 stem and a
  3x3/2 max pool, then 3, 4 and 6 bottlenecks (1x1, 3x3, 1x1 x4), the first
  of stages 2 and 3 at stride 2 in its 3x3 conv, a 1x1 projection where the
  shape changes, each conv followed by a frozen BatchNorm (``x * scale +
  bias``). Stride-2 3x3 convs pad as TensorFlow's ``SAME`` (the extra row
  and column at the bottom and right), the system's convention.
- ROI align (He et al., arXiv:1703.06870) at 7x7 bins, two bilinear samples
  per bin and axis averaged, on the feature map at 1/16 scale; then fc6, fc7
  (ReLU each) and the output layers: AZ-Net's zoom score, 11 adjacency scores
  and 44 deltas (arXiv:1512.07711), or Fast R-CNN's class scores and
  per-class box deltas (arXiv:1504.08083).
- The preprocess: BGR pixel means subtracted, a bilinear resize (half-pixel
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
import math

import torch
import torch.nn.functional as F

VGG16_LAYOUT = (
    ("conv1_1", 64), ("conv1_2", 64), ("pool1", None),
    ("conv2_1", 128), ("conv2_2", 128), ("pool2", None),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("pool3", None),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("pool4", None),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
)
RESNET50_STAGES = (3, 4, 6)  # bottlenecks of conv2_x .. conv4_x


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


# -- parameters ---------------------------------------------------------------

def vgg16_specs(width: float = 1.0):
    """``([(name, shape, kind)], out_channels)`` of the VGG-16 trunk."""
    out, c = [], 3
    for name, ch in VGG16_LAYOUT:
        if ch is None:
            continue
        ch = max(int(ch * width), 8)
        out += [(f"trunk.{name}.weight", (ch, c, 3, 3), "fan_in"),
                (f"trunk.{name}.bias", (ch,), "bias")]
        c = ch
    return out, c


def _bn(prefix: str, ch: int):
    return [(f"{prefix}.scale", (ch,), "bn_scale"), (f"{prefix}.bias", (ch,), "bias")]


def resnet50_specs():
    out = [("trunk.conv1.weight", (64, 3, 7, 7), "fan_in"), *_bn("trunk.bn1", 64)]
    c_in = 64
    for stage, n in enumerate(RESNET50_STAGES):
        ch = 64 * 2 ** stage
        for b in range(n):
            p = f"trunk.layer{stage + 1}_block{b}"
            out += [(f"{p}.conv1.weight", (ch, c_in, 1, 1), "fan_in"), *_bn(f"{p}.bn1", ch),
                    (f"{p}.conv2.weight", (ch, ch, 3, 3), "fan_in"), *_bn(f"{p}.bn2", ch),
                    (f"{p}.conv3.weight", (4 * ch, ch, 1, 1), "fan_in"), *_bn(f"{p}.bn3", 4 * ch)]
            if b == 0:
                out += [(f"{p}.downsample.weight", (4 * ch, c_in, 1, 1), "fan_in"),
                        *_bn(f"{p}.downsample_bn", 4 * ch)]
            c_in = 4 * ch
    return out, c_in


def head_specs(kind: str, in_dim: int, fc_dim: int, fc7_dim: int, outputs: dict):
    """fc6, fc7 and the output layers ``{name: (rows, kind)}``."""
    d7 = fc7_dim or fc_dim
    out = [("head.fc.fc6.weight", (fc_dim, in_dim), "fan_in"), ("head.fc.fc6.bias", (fc_dim,), "bias"),
           ("head.fc.fc7.weight", (d7, fc_dim), "fan_in"), ("head.fc.fc7.bias", (d7,), "bias")]
    for name, (rows, init) in outputs.items():
        out += [(f"head.{name}.weight", (rows, d7), init), (f"head.{name}.bias", (rows,), "bias")]
    return out


def head_outputs(kind: str, model: dict) -> dict:
    """The output layers of a head, in the order of its one fused dot."""
    if kind == "az":
        k = model["NUM_TEMPLATES"]
        return {"zoom_score": (1, "score"), "adj_score": (k, "score"), "adj_bbox": (4 * k, "bbox")}
    c = model["NUM_CLASSES"]
    return {"cls_score": (c, "score"), "bbox_pred": (4 * c, "bbox")}


def param_specs(model: dict, kind: str):
    """Every parameter of the ``kind`` (``'az'`` or ``'frcnn'``) network of a
    config's ``MODEL`` section: ``[(name, shape, init)]``, ``init`` one of
    ``fan_in`` (normal, std 1/sqrt(fan-in)), ``score`` (std 0.01), ``bbox``
    (std 0.001), ``bias`` (std 0.01) and ``bn_scale`` (1 + 0.1 normal)."""
    if model["BACKBONE"] == "vgg16":
        trunk, c = vgg16_specs(model["WIDTH"])
    elif model["BACKBONE"] == "resnet50":
        trunk, c = resnet50_specs()
    else:
        raise ValueError(f"no reference for backbone {model['BACKBONE']!r}")
    in_dim = model["POOL_SIZE"] ** 2 * c
    return trunk + head_specs(kind, in_dim, model["FC_DIM"], model["FC7_DIM"],
                              head_outputs(kind, model))


def init_std(shape, init: str) -> tuple:
    """``(std, mean)`` of a parameter's normal draw."""
    return {"fan_in": (1.0 / math.sqrt(math.prod(shape[1:]) if len(shape) > 1 else 1.0), 0.0),
            "score": (0.01, 0.0), "bbox": (0.001, 0.0), "bias": (0.01, 0.0),
            "bn_scale": (0.1, 1.0)}[init]


# -- trunks -------------------------------------------------------------------

def _conv(x, w, b=None, q=_ident, **kw):
    return F.conv2d(q(x), q(w), b, **kw)


def vgg16_trunk(p: dict, x: torch.Tensor, q=_ident) -> torch.Tensor:
    """``[B, H, W, 3]`` -> ``[B, H/16, W/16, C]``."""
    x = x.permute(0, 3, 1, 2)
    for name, ch in VGG16_LAYOUT:
        if ch is None:
            x = F.max_pool2d(x, 2, 2)
        else:
            x = F.relu(_conv(x, p[f"trunk.{name}.weight"], p[f"trunk.{name}.bias"], q, padding=1))
    return x.permute(0, 2, 3, 1)


def _frozen_bn(p, prefix, x):
    return x * p[f"{prefix}.scale"][:, None, None] + p[f"{prefix}.bias"][:, None, None]


def _pad_same(x, k: int, s: int):
    """TensorFlow's ``SAME`` padding of NCHW ``x`` for a k x k / s conv."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def resnet50_trunk(p: dict, x: torch.Tensor, q=_ident) -> torch.Tensor:
    """``[B, H, W, 3]`` -> conv4_x features ``[B, H/16, W/16, 1024]``."""
    x = x.permute(0, 3, 1, 2)
    x = F.relu(_frozen_bn(p, "trunk.bn1", _conv(x, p["trunk.conv1.weight"], q=q, stride=2, padding=3)))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for stage, n in enumerate(RESNET50_STAGES):
        for b in range(n):
            pre = f"trunk.layer{stage + 1}_block{b}"
            stride = 2 if stage > 0 and b == 0 else 1
            y = F.relu(_frozen_bn(p, f"{pre}.bn1", _conv(x, p[f"{pre}.conv1.weight"], q=q)))
            w2 = p[f"{pre}.conv2.weight"]
            y = (_conv(y, w2, q=q, padding=1) if stride == 1
                 else _conv(_pad_same(y, 3, 2), w2, q=q, stride=2))
            y = F.relu(_frozen_bn(p, f"{pre}.bn2", y))
            y = _frozen_bn(p, f"{pre}.bn3", _conv(y, p[f"{pre}.conv3.weight"], q=q))
            res = x
            if b == 0:
                res = _frozen_bn(p, f"{pre}.downsample_bn",
                                 _conv(x, p[f"{pre}.downsample.weight"], q=q, stride=stride))
            x = F.relu(y + res)
    return x.permute(0, 2, 3, 1)


def trunk(model: dict, p: dict, x: torch.Tensor, q=_ident) -> torch.Tensor:
    fn = {"vgg16": vgg16_trunk, "resnet50": resnet50_trunk}[model["BACKBONE"]]
    with ieee_fp32():
        return fn(p, x.float(), q)


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


def head(model: dict, kind: str, p: dict, pooled: torch.Tensor, q=_ident) -> dict:
    """fc6 -> ReLU -> fc7 -> ReLU -> the output layers (one dot)."""
    x = pooled.reshape(pooled.shape[0], -1)
    outs = head_outputs(kind, model)
    with ieee_fp32():
        for fc in ("fc6", "fc7"):
            x = F.relu(F.linear(q(x), q(p[f"head.fc.{fc}.weight"]), p[f"head.fc.{fc}.bias"]))
        w = torch.cat([p[f"head.{n}.weight"] for n in outs])
        b = torch.cat([p[f"head.{n}.bias"] for n in outs])
        y = F.linear(q(x), q(w), b)
    if kind == "az":
        k = model["NUM_TEMPLATES"]
        return {"zoom": y[:, 0], "adj_score": y[:, 1:1 + k],
                "adj_delta": y[:, 1 + k:].reshape(-1, k, 4)}
    c = model["NUM_CLASSES"]
    return {"cls_score": y[:, :c], "bbox_pred": y[:, c:]}


def roi_forward(model: dict, kind: str, p: dict, feat, rois, q=_ident) -> dict:
    pooled = roi_align(q(feat), rois, model["FEAT_STRIDE"], model["POOL_SIZE"])
    return head(model, kind, p, pooled, q)


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
