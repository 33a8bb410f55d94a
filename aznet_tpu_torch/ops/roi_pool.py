"""ROI pooling, the three modes of ``aznet_tpu/ops/roi_pool.py``:

- ``'align'``: separable triangle-weight contractions (``roi_align``, and
  ``roi_align_int8`` on int8 features);
- ``'align_pallas'``: the fused ROI align (``roi_align_fused``), the CUDA
  kernel on the card and its plain version on the CPU;
- ``'caffe_max'``: Caffe's ROI max pooling (``roi_pool_caffe``).

Pooled features are NHWC ``[R, P, P, C]``, as in the reference, so fc6
consumes them in the reference's flatten order with no permutation.
"""

from __future__ import annotations

import torch

from aznet_tpu_torch.ops import refuse_grad
from aznet_tpu_torch.ops.conv_int8 import EXACT_C
from aznet_tpu_torch.ops.cuda import roi_align_kernel
from aznet_tpu_torch.utils.precision import float32_precision

ROI_CHUNK = 256  # rois per contraction, to bound the intermediate's memory


def sample_grid(n: int, device) -> torch.Tensor:
    """``(i + 0.5) / n`` for ``i < n``, float32, on ``device``. Built on the
    host with a true division and then moved: on a CUDA tensor PyTorch turns
    ``x / python_number`` into ``x * (1 / n)``, which can differ from the
    reference's division by an ulp."""
    return ((torch.arange(n, dtype=torch.float32) + 0.5) / n).to(device)


def _bilinear_pool_weights(lo, size, extent: int, pool: int, sampling: int):
    """``[R, pool, extent]`` weights: per bin, the mean of ``sampling``
    bilinear samples along one axis (each row sums to 1)."""
    n = pool * sampling
    dev = lo.device
    grid = sample_grid(n, dev)
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


@float32_precision()
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


def _exact_int_sum(equation: str, weights8, featf, axis: int):
    """``einsum(equation, weights8, featf)`` of integer-valued float32
    operands (``|values| <= 127``) contracted over ``featf``'s ``axis``: in
    one float32 sum when the extent is at most :data:`EXACT_C` (exact), else
    over pieces of that extent, each exact, added in int32 and converted to
    float32 once, as an int32 accumulator would be."""
    n = featf.shape[axis]
    if n <= EXACT_C:
        return torch.einsum(equation, weights8, featf)
    return sum(torch.einsum(equation, weights8[..., i:i + EXACT_C],
                            featf.narrow(axis, i, min(EXACT_C, n - i))).to(torch.int32)
               for i in range(0, n, EXACT_C)).float()


def roi_align_int8(feat8, rois, spatial_scale: float, pool_size: int = 7,
                   sampling: int = 2, w_first=None):
    """ROI align over int8 features ``[H, W, C]`` -> int8 ``[R, P, P, C]`` at
    the same scale (each weight row sums to 1, so the pooled values stay in
    range). The first contraction takes int8 weights ``round(w * 127)`` and
    the int8 features to an exact integer sum (float32 sums over at most
    1040 cells of the extent at a time, each exact, added in int32), scaled
    by ``float32(1/127)`` and rounded to bf16; the second is bf16 x bf16
    with float32 accumulation, computed in float32 on bf16-valued operands
    so that it rounds once; then round and clip."""
    h, w, c = feat8.shape
    if feat8.dtype != torch.int8:
        raise TypeError(f"roi_align_int8 wants int8 features, got {feat8.dtype}")
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
            cols = _exact_int_sum("rqw,hwc->rqhc", torch.round(wx * 127.0), featf, 1)
            pooled = torch.einsum("rph,rqhc->rpqc", bf16_valued(wy),
                                  bf16_valued(cols * inv127))
        else:
            rows = _exact_int_sum("rph,hwc->rpwc", torch.round(wy * 127.0), featf, 0)
            pooled = torch.einsum("rqw,rpwc->rpqc", bf16_valued(wx),
                                  bf16_valued(rows * inv127))
        return torch.round(pooled).clamp_(-127.0, 127.0).to(torch.int8)

    if rois.shape[0] <= ROI_CHUNK:
        return one_chunk(rois)
    return torch.cat([one_chunk(rois[i:i + ROI_CHUNK])
                      for i in range(0, rois.shape[0], ROI_CHUNK)])


FUSED_TILE_R = 16  # the reference kernel's roi tile, a term of its order rule
FUSED_CHUNK = 64  # rois per step of the plain fused version (bounds its memory)
CAFFE_CHUNK = 32  # rois per gather of roi_pool_caffe (bounds its memory)


def fused_w_first(h: int, w: int, c: int, itemsize: int, pool_size: int = 7) -> bool:
    """Contraction order of the fused ROI align: ``roi_align_pallas``'s
    footprint rule (feat + one roi tile's rows + its output over 12 MB picks
    the W-first kernel). The rule was set by the TPU's memory, but it selects
    the numerics (which intermediate is rounded), so the port keeps it as an
    order selector and none of the TPU's tiles."""
    footprint = (h * w * c + FUSED_TILE_R * pool_size * w * c
                 + FUSED_TILE_R * pool_size * pool_size * c) * itemsize
    return footprint > 12 * 1024 * 1024


def fused_taps(lo, size, extent: int, pool: int):
    """Per roi and bin, the cells of one axis where the bin's weight can be
    nonzero and their weights: ``(cells [R, P, 4] int64, weights [R, P, 4]
    f32)``. The bin's two samples sit at ``lo + (i + 0.5) / (2P) * size``,
    clipped to ``[0, extent - 1]``; each cell weighs the mean of the two
    triangles ``max(1 - |pos - cell|, 0)``, which is nonzero only on
    ``floor(pos)`` and ``floor(pos) + 1``. Slots in ascending cell order:
    ``f0, f0 + 1, f1, f1 + 1``; a slot that repeats a cell or leaves the map
    has weight 0 (its cell is clamped into the map)."""
    grid = sample_grid(2 * pool, lo.device)
    pos = (lo[:, None] + grid * size[:, None]).clamp(0.0, extent - 1.0).reshape(-1, pool, 2)
    f0, f1 = torch.floor(pos).long().unbind(-1)
    cells = torch.stack([f0, f0 + 1, f1, f1 + 1], -1)
    live = torch.stack([torch.ones_like(f0, dtype=torch.bool), f0 + 1 < extent,
                        f1 > f0 + 1, (f1 > f0) & (f1 + 1 < extent)], -1)
    cf = cells.float()

    def tri(p):
        return (1.0 - (p[..., None] - cf).abs()).clamp(min=0.0)

    wts = (tri(pos[..., 0]) + tri(pos[..., 1])) * 0.5
    return cells.clamp(max=extent - 1), torch.where(live, wts, 0.0)


def roi_align_fused_reference(feat, rois, spatial_scale: float, pool_size: int = 7,
                              w_first: bool = False):
    """Plain PyTorch version of the fused ROI-align kernel (the function of
    ``aznet_tpu/ops/pallas/roi_kernel.py``): ``feat [H, W, C]`` bf16/f32,
    ``rois [R, 4]`` f32 -> ``[R, P, P, C]`` in ``feat``'s dtype.

    Weights from :func:`fused_taps`, rounded to the feature dtype. H-first:
    ``rows[p, w] = sum_h wy[p, h] * feat[h, w]`` then ``out[p, q] = sum_w
    wx[q, w] * rows[p, w]``; W-first: ``cols[q, h]`` over w, then the sum
    over h. Each sum runs over the four tap slots in ascending cell order,
    one f32 multiply and one f32 add per step (zero-weight slots add
    nothing), and its result is rounded to the feature dtype: the
    intermediate before the second sum, the output after it."""
    h, w, c = feat.shape
    p = pool_size
    dt = feat.dtype
    featf = feat.float()

    def tap_sum(weights, values):
        acc = torch.zeros_like(values[0])
        for wk, vk in zip(weights, values):
            acc = acc + wk * vk
        return acc

    def one_chunk(r):
        x1, y1, x2, y2 = (r * spatial_scale).unbind(-1)
        cy, wy = fused_taps(y1, (y2 - y1).clamp(min=1.0), h, p)
        cx, wx = fused_taps(x1, (x2 - x1).clamp(min=1.0), w, p)
        wy, wx = wy.to(dt).float(), wx.to(dt).float()
        n = r.shape[0]
        if w_first:
            # cols [R, Q, H, C]; then gather h per (p, k): [R, Q, P, C].
            feat_t = featf.permute(1, 0, 2)
            cols = tap_sum([wx[:, :, k, None, None] for k in range(4)],
                           [feat_t[cx[:, :, k]] for k in range(4)]).to(dt).float()
            idx = [cy[:, None, :, k, None].expand(n, p, p, c) for k in range(4)]
            out = tap_sum([wy[:, None, :, k, None] for k in range(4)],
                          [torch.gather(cols, 2, i) for i in idx])
            return out.permute(0, 2, 1, 3).to(dt)
        rows = tap_sum([wy[:, :, k, None, None] for k in range(4)],
                       [featf[cy[:, :, k]] for k in range(4)]).to(dt).float()  # [R, P, W, C]
        idx = [cx[:, None, :, k, None].expand(n, p, p, c) for k in range(4)]
        return tap_sum([wx[:, None, :, k, None] for k in range(4)],
                       [torch.gather(rows, 2, i) for i in idx]).to(dt)

    if rois.shape[0] == 0:
        return feat.new_zeros((0, p, p, c))
    return torch.cat([one_chunk(rois[i:i + FUSED_CHUNK])
                      for i in range(0, rois.shape[0], FUSED_CHUNK)])


def roi_align_fused(feat, rois, spatial_scale: float, pool_size: int = 7):
    """``'align_pallas'`` mode: the fused ROI align (counterpart of
    ``roi_align_pallas``), bf16 or f32 features. A CUDA tensor launches the
    CUDA kernel (``ops/cuda/roi_align_kernel.py``), a CPU tensor takes
    :func:`roi_align_fused_reference`; the order is :func:`fused_w_first`."""
    if feat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the fused ROI align takes bf16 or f32 features, got {feat.dtype}")
    h, w, c = feat.shape
    wf = fused_w_first(h, w, c, feat.element_size(), pool_size)
    if rois.dtype != torch.float32:
        rois = rois.float()
    if feat.is_cuda:
        return roi_align_kernel.roi_align_cuda(feat, rois, spatial_scale, pool_size, wf)
    if feat.device.type != "cpu":
        raise ValueError(f"no fused ROI align for device {feat.device}")
    return roi_align_fused_reference(feat, rois, spatial_scale, pool_size, wf)


def roi_pool_caffe(feat, rois, spatial_scale: float, pool_size: int = 7):
    """``'caffe_max'`` mode, Caffe ROIPooling: ``feat [H, W, C]``, ``rois
    [R, 4]`` image coordinates -> ``[R, P, P, C]``. Roi corners round to the
    feature grid in float32 (``floor(x * scale + 0.5)``), ``roi_w = max(x2 -
    x1 + 1, 1)``, bin boundaries ``floor(p * roi / P)`` and ``ceil((p + 1) *
    roi / P)`` in exact integer arithmetic, clipped to the map; max over the
    bin, 0 for an empty bin (``aznet_tpu/ops/roi_pool.py::roi_pool_caffe``)."""
    h, w, c = feat.shape
    p = pool_size
    # A bin spans at most roi/P + 2 cells; rounded rois span at most H + 1.
    mbh = -(-(h + 1) // p) + 2
    mbw = -(-(w + 1) // p) + 2
    dev = feat.device
    ps = torch.arange(p, device=dev)
    neg = torch.tensor(float("-inf"), dtype=feat.dtype, device=dev)

    def bins(lo, hi, extent, span):
        size = (hi - lo + 1).clamp(min=1)[:, None]
        start = ((ps * size) // p + lo[:, None]).clamp(0, extent)
        end = (-((-(ps + 1) * size) // p) + lo[:, None]).clamp(0, extent)
        idx = start[..., None] + torch.arange(span, device=dev)  # [R, P, span]
        return idx.clamp(max=extent - 1), idx < end[..., None]

    def one_chunk(r):
        x1, y1, x2, y2 = torch.floor(r.float() * spatial_scale + 0.5).long().unbind(-1)
        hidx, hvalid = bins(y1, y2, h, mbh)
        widx, wvalid = bins(x1, x2, w, mbw)
        vals = feat[hidx[:, :, None, :, None], widx[:, None, :, None, :]]
        mask = (hvalid[:, :, None, :, None] & wvalid[:, None, :, None, :])[..., None]
        pooled = torch.where(mask, vals, neg).amax(dim=(3, 4))
        return torch.where(mask.any(dim=(3, 4)), pooled, 0.0).to(feat.dtype)

    if rois.shape[0] == 0:
        return feat.new_zeros((0, p, p, c))
    return torch.cat([one_chunk(rois[i:i + CAFFE_CHUNK])
                      for i in range(0, rois.shape[0], CAFFE_CHUNK)])


POOLING_MODES = ("align", "align_pallas", "caffe_max")


def roi_pool(feat, rois, spatial_scale: float, pool_size: int = 7,
             mode: str = "align"):
    """Dispatch on ``cfg.MODEL.POOLING_MODE``: ``'align'`` (the einsums),
    ``'align_pallas'`` (:func:`roi_align_fused`), ``'caffe_max'``
    (:func:`roi_pool_caffe`). int8 features take :func:`roi_align_int8` and
    pool to int8, in ``'align'`` mode only."""
    if mode not in POOLING_MODES:
        raise ValueError(f"unknown POOLING_MODE {mode!r}; options: {POOLING_MODES}")
    if feat.dtype == torch.int8:
        if mode != "align":
            raise ValueError(f"int8 features need POOLING_MODE 'align', got {mode!r}")
        return roi_align_int8(feat, rois, spatial_scale, pool_size)
    if not feat.is_floating_point():
        raise ValueError(f"roi_pool needs float or int8 features, got {feat.dtype}")
    if mode == "align_pallas":
        refuse_grad("POOLING_MODE='align_pallas' (the fused ROI-align kernel)", feat)
        return roi_align_fused(feat, rois, spatial_scale, pool_size)
    if mode == "caffe_max":
        return roi_pool_caffe(feat, rois, spatial_scale, pool_size)
    return roi_align(feat, rois, spatial_scale, pool_size)
