"""Plain PyTorch reference of the ResNet-101 C4 detector (He et al.,
arXiv:1512.03385: Table 1's 101-layer column, Appendix A's Faster R-CNN
baseline), in float32 with TF32 off, for the port's tests. It imports
nothing of the port and nothing of JAX, so that its answers are its own.

- The trunk: the 7x7/2 stem with frozen BatchNorm and ReLU, a 3x3/2 max
  pool, then 3, 4 and 23 bottlenecks (1x1, 3x3, 1x1 x4), the first of
  conv3_x and conv4_x at stride 2 in its 3x3 conv with TensorFlow's SAME
  padding (the extra row and column at the bottom and right), a 1x1
  projection where the shape changes; stride 16, 1024 channels.
- ROI align (arXiv:1703.06870) at ``pool`` x ``pool`` bins, two bilinear
  samples a bin and axis averaged, on the map at 1/16 scale.
- conv5_x on each pool: three bottlenecks 512 wide inside and 2048 out, the
  first at stride 2 in its 3x3 (SAME) and projected by a stride-2 1x1; then
  the mean over the 7x7 output and the output layers as one dot.
- The preprocess and the box decode of the detect entry: BGR means
  subtracted, a bilinear resize (half-pixel centres) onto a zero-padded
  canvas; Fast R-CNN's decode (``x2 = ctr + w / 2``) clipped to the image.

Tensors are NHWC at the boundaries. The parameters are a flat dict under
the port's names (``trunk.layer3_block22.conv2.weight``,
``head.fc.layer4_block0.downsample_bn.scale``, ``head.cls_score.weight``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

TRUNK_STAGES = (3, 4, 23)  # conv2_x, conv3_x, conv4_x
HEAD_STAGE, HEAD_BLOCKS = 3, 3  # conv5_x
FEAT_STRIDE = 16
OUTPUTS = {"az": ("zoom_score", "adj_score", "adj_bbox"), "frcnn": ("cls_score", "bbox_pred")}


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


def frozen_bn(p: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
    return x * p[f"{prefix}.scale"][:, None, None] + p[f"{prefix}.bias"][:, None, None]


def pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TensorFlow's SAME padding of NCHW ``x`` for a k x k / s conv."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def stage(p: dict, prefix: str, stage_i: int, n: int, x: torch.Tensor, stride: int) -> torch.Tensor:
    """``n`` bottlenecks ``<prefix>.layer<stage_i + 1>_block<b>`` on NCHW
    ``x``, the first at ``stride`` in its 3x3 conv and projected."""
    for b in range(n):
        pre = f"{prefix}.layer{stage_i + 1}_block{b}"
        s = stride if b == 0 else 1
        y = F.relu(frozen_bn(p, f"{pre}.bn1", F.conv2d(x, p[f"{pre}.conv1.weight"])))
        w2 = p[f"{pre}.conv2.weight"]
        y = F.conv2d(y, w2, padding=1) if s == 1 else F.conv2d(pad_same(y, 3, 2), w2, stride=2)
        y = F.relu(frozen_bn(p, f"{pre}.bn2", y))
        y = frozen_bn(p, f"{pre}.bn3", F.conv2d(y, p[f"{pre}.conv3.weight"]))
        res = x
        if b == 0:
            res = frozen_bn(p, f"{pre}.downsample_bn",
                            F.conv2d(x, p[f"{pre}.downsample.weight"], stride=s))
        x = F.relu(y + res)
    return x


def trunk(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 3]`` -> conv4_x features ``[B, H/16, W/16, 1024]``."""
    with ieee_fp32():
        x = x.float().permute(0, 3, 1, 2)
        x = F.relu(frozen_bn(p, "trunk.bn1", F.conv2d(x, p["trunk.conv1.weight"], stride=2,
                                                      padding=3)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for s, n in enumerate(TRUNK_STAGES):
            x = stage(p, "trunk", s, n, x, 2 if s > 0 else 1)
        return x.permute(0, 2, 3, 1)


def _bin_weights(lo, size, extent: int, pool: int):
    """``[R, pool, extent]``: per bin, the mean of its two bilinear samples'
    weights on the cells of one axis (samples clipped into the map)."""
    n = 2 * pool
    grid = ((torch.arange(n, dtype=torch.float32) + 0.5) / n).to(lo.device)
    pos = (lo[:, None] + grid[None, :] * size[:, None]).clamp(0.0, extent - 1.0)
    cells = torch.arange(extent, dtype=torch.float32, device=lo.device)
    w = (1.0 - (pos[:, :, None] - cells).abs()).clamp(min=0.0)
    return w.reshape(lo.shape[0], pool, 2, extent).mean(2)


def roi_align(feat: torch.Tensor, rois: torch.Tensor, pool: int = 14) -> torch.Tensor:
    """``feat [H, W, C]``, ``rois [R, 4]`` in image coordinates -> ``[R, pool,
    pool, C]``."""
    h, w, _ = feat.shape
    with ieee_fp32():
        x1, y1, x2, y2 = (rois.float() * (1.0 / FEAT_STRIDE)).unbind(-1)
        wy = _bin_weights(y1, (y2 - y1).clamp(min=1.0), h, pool)
        wx = _bin_weights(x1, (x2 - x1).clamp(min=1.0), w, pool)
        rows = torch.einsum("rph,hwc->rpwc", wy, feat.float())
        return torch.einsum("rqw,rpwc->rpqc", wx, rows).contiguous()


def conv5(p: dict, pooled: torch.Tensor) -> torch.Tensor:
    """conv5_x on ``[R, P, P, 1024]`` pools, then the mean over its output:
    ``[R, 2048]``."""
    with ieee_fp32():
        x = stage(p, "head.fc", HEAD_STAGE, HEAD_BLOCKS, pooled.float().permute(0, 3, 1, 2), 2)
        return x.mean((2, 3))


def head(p: dict, kind: str, pooled: torch.Tensor, num_templates: int = 11) -> dict:
    """conv5_x, the pool and the output layers as one dot: ``zoom``,
    ``adj_score``, ``adj_delta [R, K, 4]`` (``'az'``) or ``cls_score``,
    ``bbox_pred`` (``'frcnn'``)."""
    x = conv5(p, pooled)
    names = OUTPUTS[kind]
    w = torch.cat([p[f"head.{n}.weight"] for n in names])
    b = torch.cat([p[f"head.{n}.bias"] for n in names])
    with ieee_fp32():
        y = F.linear(x, w, b)
    if kind == "az":
        k = num_templates
        return {"zoom": y[:, 0], "adj_score": y[:, 1:1 + k],
                "adj_delta": y[:, 1 + k:].reshape(-1, k, 4)}
    c = p["head.cls_score.weight"].shape[0]
    return {"cls_score": y[:, :c], "bbox_pred": y[:, c:]}


def roi_forward(p: dict, kind: str, feat: torch.Tensor, rois: torch.Tensor, pool: int = 14,
                num_templates: int = 11) -> dict:
    return head(p, kind, roi_align(feat, rois, pool), num_templates)


def compute_scale(h: int, w: int, target: int, max_size: int) -> float:
    """The short side to ``target``, unless the long side would pass
    ``max_size``."""
    scale = float(target) / float(min(h, w))
    if round(scale * max(h, w)) > max_size:
        scale = float(max_size) / float(max(h, w))
    return scale


def canvas_for(h: int, w: int, target: int, max_size: int, bucket: int = 64) -> tuple:
    """The one-image canvas: the scaled size rounded up to ``bucket``."""
    s = compute_scale(h, w, target, max_size)
    return tuple(int(-(-int(round(v * s)) // bucket) * bucket) for v in (h, w))


def preprocess(im: torch.Tensor, means, scale: float, out_h: int, out_w: int) -> torch.Tensor:
    """Raw ``im [H, W, 3]`` (uint8 BGR) -> ``[out_h, out_w, 3]`` float32: the
    means subtracted, then a bilinear resize by ``scale`` (half-pixel
    centres, edge samples clamped) as two triangle-weight matmuls, zero past
    the scaled extent."""
    hp, wp, c = im.shape
    dev = im.device
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
        rows = (weights(out_h, hp, vh) @ x.reshape(hp, wp * c)).reshape(out_h, wp, c)
        rows = rows.permute(1, 0, 2).reshape(wp, out_h * c)
        return (weights(out_w, wp, vw) @ rows).reshape(out_w, out_h, c).permute(1, 0, 2)


def decode(boxes: torch.Tensor, deltas: torch.Tensor, h: float, w: float,
           offset: float = 1.0) -> torch.Tensor:
    """Fast R-CNN's decode of ``deltas [R, 4K]`` against ``boxes [R, 4]``
    (``x2 = ctr + w / 2``), clipped to x in [0, w - offset], y in [0, h -
    offset]: ``[R, 4K]``."""
    d = deltas.reshape(deltas.shape[0], -1, 4)
    bw = (boxes[:, 2] - boxes[:, 0] + offset)[:, None]
    bh = (boxes[:, 3] - boxes[:, 1] + offset)[:, None]
    cx, cy = boxes[:, 0, None] + 0.5 * bw, boxes[:, 1, None] + 0.5 * bh
    pcx, pcy = d[..., 0] * bw + cx, d[..., 1] * bh + cy
    pw, ph = torch.exp(d[..., 2]) * bw, torch.exp(d[..., 3]) * bh
    x1, x2 = (pcx - 0.5 * pw).clamp(0.0, w - offset), (pcx + 0.5 * pw).clamp(0.0, w - offset)
    y1, y2 = (pcy - 0.5 * ph).clamp(0.0, h - offset), (pcy + 0.5 * ph).clamp(0.0, h - offset)
    return torch.stack([x1, y1, x2, y2], -1).reshape(deltas.shape)


def detect(p: dict, images: torch.Tensor, boxes: torch.Tensor, canvas, target: int,
           max_size: int, means, pool: int = 14) -> tuple:
    """Raw ``images [B, H, W, 3]`` and ``boxes [B, R, 4]`` (original
    coordinates) on a ``canvas`` (h, w) -> ``(softmax scores [B, R, K],
    decoded boxes [B, R, 4K])``."""
    _, h, w, _ = images.shape
    scale = compute_scale(h, w, target, max_size)
    blobs = torch.stack([preprocess(im, means, scale, *canvas) for im in images])
    feats = trunk(p, blobs)
    scores, pred = [], []
    for feat, b in zip(feats, boxes):
        out = roi_forward(p, "frcnn", feat, b.float() * scale, pool)
        scores.append(torch.softmax(out["cls_score"], -1))
        pred.append(decode(b.float(), out["bbox_pred"], float(h), float(w)))
    return torch.stack(scores), torch.stack(pred)
