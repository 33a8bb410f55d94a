"""ROI align as separable triangle-weight contractions (``'align'`` mode of
``aznet_tpu/ops/roi_pool.py``: ``roi_align`` and ``roi_align_int8``).

Pooled features are NHWC ``[R, P, P, C]``, as in the reference, so fc6
consumes them in the reference's flatten order with no permutation.
"""

from __future__ import annotations

import torch

ROI_CHUNK = 256  # rois per contraction, to bound the intermediate's memory


def _bilinear_pool_weights(lo, size, extent: int, pool: int, sampling: int):
    """``[R, pool, extent]`` weights: per bin, the mean of ``sampling``
    bilinear samples along one axis (each row sums to 1)."""
    n = pool * sampling
    dev = lo.device
    grid = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n
    pos = (lo[:, None] + grid[None, :] * size[:, None]).clamp(0.0, extent - 1.0)
    cells = torch.arange(extent, dtype=torch.float32, device=dev)
    w = (1.0 - (pos[:, :, None] - cells).abs()).clamp(min=0.0)
    return w.reshape(lo.shape[0], pool, sampling, extent).mean(dim=2)


def _contract_w_first(h: int, w: int, c: int, itemsize: int, override=None) -> bool:
    """Contract W first when that stages the smaller intermediate on a map
    over 8 MB (the reference's rule); small maps keep the H-first order."""
    if override is not None:
        return bool(override)
    return w > h and h * w * c * itemsize > 8 * 1024 * 1024


def roi_align(feat, rois, spatial_scale: float, pool_size: int = 7,
              sampling: int = 2, w_first=None):
    """``feat [H, W, C]``, ``rois [R, 4]`` image coords -> ``[R, P, P, C]``:
    continuous coordinates, ``sampling**2`` bilinear samples averaged per bin.

    Both contractions accumulate in f32; with bf16 features the intermediate
    is rounded to bf16 between them, as in the reference. ``w_first`` pins
    the contraction order (default: the size rule)."""
    h, w, c = feat.shape
    p = pool_size
    wf = _contract_w_first(h, w, c, feat.element_size(), w_first)

    def one_chunk(r):
        x1, y1, x2, y2 = (r * spatial_scale).unbind(-1)
        wy = _bilinear_pool_weights(y1, (y2 - y1).clamp(min=1.0), h, p, sampling).to(feat.dtype)
        wx = _bilinear_pool_weights(x1, (x2 - x1).clamp(min=1.0), w, p, sampling).to(feat.dtype)
        if wf:
            cols = torch.einsum("rqw,hwc->rqhc", wx, feat)
            return torch.einsum("rph,rqhc->rpqc", wy, cols)
        rows = torch.einsum("rph,hwc->rpwc", wy, feat)
        return torch.einsum("rqw,rpwc->rpqc", wx, rows)

    if rois.shape[0] <= ROI_CHUNK:
        return one_chunk(rois)
    return torch.cat([one_chunk(rois[i:i + ROI_CHUNK])
                      for i in range(0, rois.shape[0], ROI_CHUNK)])


def roi_align_int8(feat8, rois, spatial_scale: float, pool_size: int = 7,
                   sampling: int = 2, w_first=None):
    """ROI align over int8 features ``[H, W, C]`` -> int8 ``[R, P, P, C]`` at
    the same scale (each weight row sums to 1, so the pooled values stay in
    range). The first contraction takes int8 weights ``round(w * 127)`` and
    the int8 features to an exact integer sum, computed in float32 (exact for
    an extent <= 1040), scaled by ``float32(1/127)`` and rounded to bf16; the
    second is bf16 x bf16 with float32 accumulation, computed in float32 on
    bf16-valued operands so that it rounds once; then round and clip."""
    h, w, c = feat8.shape
    if feat8.dtype != torch.int8:
        raise TypeError(f"roi_align_int8 wants int8 features, got {feat8.dtype}")
    if max(h, w) > 1040:
        raise ValueError(f"the float32 integer sums are exact for extents <= 1040, got {h}x{w}")
    p = pool_size
    wf = _contract_w_first(h, w, c, 1, w_first)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=feat8.device)
    featf = feat8.float()

    def bf16_valued(t):
        return t.to(torch.bfloat16).float()

    def one_chunk(r):
        x1, y1, x2, y2 = (r * spatial_scale).unbind(-1)
        wy = _bilinear_pool_weights(y1, (y2 - y1).clamp(min=1.0), h, p, sampling)
        wx = _bilinear_pool_weights(x1, (x2 - x1).clamp(min=1.0), w, p, sampling)
        if wf:
            wx8 = torch.round(wx * 127.0)
            cols = bf16_valued(torch.einsum("rqw,hwc->rqhc", wx8, featf) * inv127)
            pooled = torch.einsum("rph,rqhc->rpqc", bf16_valued(wy), cols)
        else:
            wy8 = torch.round(wy * 127.0)
            rows = bf16_valued(torch.einsum("rph,hwc->rpwc", wy8, featf) * inv127)
            pooled = torch.einsum("rqw,rpwc->rpqc", bf16_valued(wx), rows)
        return torch.round(pooled).clamp_(-127.0, 127.0).to(torch.int8)

    if rois.shape[0] <= ROI_CHUNK:
        return one_chunk(rois)
    return torch.cat([one_chunk(rois[i:i + ROI_CHUNK])
                      for i in range(0, rois.shape[0], ROI_CHUNK)])


def roi_pool(feat, rois, spatial_scale: float, pool_size: int = 7,
             mode: str = "align"):
    """Dispatch on ``cfg.MODEL.POOLING_MODE``; only ``'align'`` is ported.
    int8 features take :func:`roi_align_int8` and pool to int8."""
    if mode != "align":
        raise ValueError(f"POOLING_MODE {mode!r} is not ported (only 'align')")
    if feat.dtype == torch.int8:
        return roi_align_int8(feat, rois, spatial_scale, pool_size)
    if not feat.is_floating_point():
        raise ValueError(f"roi_align needs float or int8 features, got {feat.dtype}")
    return roi_align(feat, rois, spatial_scale, pool_size)
