"""Fused mean-subtract + bilinear resize onto a static canvas.

Counterpart of ``aznet_tpu/ops/preprocess.py`` (``compute_scale``,
``resize_bilinear_scale``, ``preprocess_image``). Images are HWC BGR; the
resize is two separable triangle-weight matmuls (rows, then columns) in the
reference's association order, with a dynamic ``scale`` and, for images
zero-padded to a static raw shape, dynamic true extents ``src_hw``. When the
blob is bf16 the matmuls run in bf16 with f32 accumulation, as the reference's.

The host functions (NumPy; the reference's ``lib/utils/blob.py``) build
calibration blobs: :func:`prep_im_for_blob`, :func:`im_list_to_blob`,
:func:`canvas_shape`.
"""

from __future__ import annotations

import numpy as np
import torch

from aznet_tpu_torch.utils.precision import float32_precision


def compute_scale(h: int, w: int, target_size: int, max_size: int) -> float:
    """The reference's scale rule: shortest side -> target, capped by max_size.
    (A copy of ``aznet_tpu.ops.preprocess.compute_scale``, whose module
    imports JAX.)"""
    im_size_min = min(h, w)
    im_size_max = max(h, w)
    scale = float(target_size) / float(im_size_min)
    if round(scale * im_size_max) > max_size:
        scale = float(max_size) / float(im_size_max)
    return scale


def _f32(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


@float32_precision()
def resize_bilinear_scale(im, scale, out_h: int, out_w: int,
                          compute_dtype=torch.float32, src_hw=None):
    """Resize ``im [H, W, C]`` by ``scale`` onto an ``[out_h, out_w, C]``
    canvas (half-pixel centres; pixels past the scaled extent are 0).
    Returns ``(canvas, valid_h, valid_w)``, the extents as int32 0-d
    tensors."""
    dev = im.device
    hp, wp, c = im.shape
    h = _f32(float(hp) if src_hw is None else src_hw[0], dev)
    w = _f32(float(wp) if src_hw is None else src_hw[1], dev)
    scale = _f32(scale, dev)
    valid_h = torch.round(h * scale).to(torch.int32)
    valid_w = torch.round(w * scale).to(torch.int32)

    def weights(n_out, extent, n_src, valid):
        pos = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) / scale - 0.5
        pos = torch.minimum(pos.clamp(min=0.0), extent - 1.0)
        cells = torch.arange(n_src, dtype=torch.float32, device=dev)
        wt = (1.0 - (pos[:, None] - cells).abs()).clamp(min=0.0)
        # Rows past the scaled extent become all-zero (the pad region).
        live = torch.arange(n_out, device=dev)[:, None] < valid
        return (wt * live).to(compute_dtype)

    wy = weights(out_h, h, hp, valid_h)
    wx = weights(out_w, w, wp, valid_w)
    im = im.to(compute_dtype)
    rows = torch.matmul(wy, im.reshape(hp, wp * c))  # [out_h, wp*c]
    rows = rows.reshape(out_h, wp, c).permute(1, 0, 2).reshape(wp, out_h * c)
    out = torch.matmul(wx, rows).reshape(out_w, out_h, c).permute(1, 0, 2)
    return out, valid_h, valid_w


def preprocess_image(im, pixel_means, target_size: int, max_size: int,
                     out_h: int, out_w: int, dtype=torch.float32,
                     src_hw=None, scale=None):
    """Mean-subtract + scale-resize + pad ``im [H, W, 3]`` (uint8 or float)
    onto ``[out_h, out_w, 3]`` of ``dtype``. Returns ``(blob, im_scale,
    (valid_h, valid_w))``. ``src_hw``/``scale``: true extents and the
    host-computed scale of an image zero-padded to a static raw shape. The
    resize computes in bf16 when ``dtype`` is bf16, else in f32."""
    compute_dtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    if scale is None:
        scale = compute_scale(im.shape[0], im.shape[1], target_size, max_size)
    scale = _f32(scale, im.device)
    centered = im.to(torch.float32) - _f32(pixel_means, im.device)
    out, vh, vw = resize_bilinear_scale(centered, scale, out_h, out_w,
                                        compute_dtype=compute_dtype, src_hw=src_hw)
    return out.to(dtype).contiguous(), scale, (vh, vw)


def canvas_shape(target_size: int, max_size: int, multiple: int = 32):
    """Static canvas large enough for any image at the reference scale rule."""
    side = int(-(-max(target_size, max_size) // multiple) * multiple)
    return side, side


def prep_im_for_blob(im: np.ndarray, pixel_means, target_size: int, max_size: int):
    """The reference's host ``prep_im_for_blob``: float32, subtract the means,
    bilinear resize (half-pixel centres) to the scale rule's size. Returns
    ``(im, im_scale)``. cv2's resize when cv2 imports, else
    :func:`_resize_bilinear_np`, as the reference."""
    im = im.astype(np.float32, copy=False) - np.asarray(pixel_means, np.float32)
    scale = compute_scale(im.shape[0], im.shape[1], target_size, max_size)
    out_h = int(round(im.shape[0] * scale))
    out_w = int(round(im.shape[1] * scale))
    try:
        import cv2
    except ImportError:
        return _resize_bilinear_np(im, out_h, out_w), scale
    return cv2.resize(im, (out_w, out_h), interpolation=cv2.INTER_LINEAR), scale


def _resize_bilinear_np(im: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = im.shape[:2]
    ys = np.clip((np.arange(out_h) + 0.5) * h / out_h - 0.5, 0, h - 1)
    xs = np.clip((np.arange(out_w) + 0.5) * w / out_w - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    rows = im[y0] * (1 - fy) + im[y1] * fy
    return rows[:, x0] * (1 - fx) + rows[:, x1] * fx


def im_list_to_blob(ims: list) -> np.ndarray:
    """Zero-pad HWC float32 images to the batch's largest -> ``[N, H, W, C]``."""
    max_shape = np.array([im.shape for im in ims]).max(axis=0)
    blob = np.zeros((len(ims), max_shape[0], max_shape[1], ims[0].shape[2]), np.float32)
    for i, im in enumerate(ims):
        blob[i, : im.shape[0], : im.shape[1]] = im
    return blob
