"""The yardstick's arithmetic: the card's published peaks, the work a
configuration fixes (FLOPs of its trunk and heads, counted from the
configuration alone), and the least time of each kernel at its call's
shapes. Device times come from the profiler; these functions only count. Each
network counts its own FLOPs (``reference/networks/<network>.py``).

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W): 989
TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in float32 outside them, and
3.35 TB/s of device memory."""

from __future__ import annotations

import re

import torch

from reference import nets, search as rs

PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12

# The port's kernels by their demangled names (anonymous namespace).
KERNELS = {
    "roi_align": re.compile(r"::roi_align_kernel[<(]"),
    "nms": re.compile(r"::(sort_kernel|sort_kernel_large|mask_kernel|scan_kernel|scan_kernel_large)[<(]"),
    "nms_scan": re.compile(r"::(scan_kernel|scan_kernel_large)[<(]"),
    "conv1": re.compile(r"::conv1_fused_kernel[<(]"),
}


def bound_s(nbytes: float, ops: float, peak: str) -> float:
    """The least time: bytes at the memory rate or operations at the peak,
    whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[peak])


# -- FLOPs of the work a configuration fixes ------------------------------------

def trunk_flops(model: dict, canvas) -> float:
    """The trunk's convolutions on a ``canvas`` (h, w) image, as its network
    (``reference/networks/<network>.py``) counts them."""
    return nets.network(model).trunk_flops(model, canvas)


def head_flops(model: dict, kind: str, rows: int) -> float:
    """The head's convolutions and dots over ``rows`` rois (fc6, fc7 and the
    fused output dot, for a head of those)."""
    return nets.network(model).head_flops(model, kind, rows)


def propose_rows(sear: dict) -> int:
    """Head rows an image: the frontier capacity of every level."""
    return sum(rs.frontier_schedule(sear))


def candidates(sear: dict, num_templates: int) -> int:
    """Candidates an image hands to NMS: a slot per (level, frontier row,
    template), capped at ``CAND_BUF``."""
    return min(propose_rows(sear) * num_templates, sear["CAND_BUF"])


# -- kernels' least times -------------------------------------------------------

def fused_w_first(h: int, w: int, c: int, itemsize: int, pool: int = 7) -> bool:
    """The ROI-align kernel's contraction order: W first where the feature
    map, one 16-roi tile's rows and its output pass 12 MB."""
    return (h * w * c + 16 * pool * w * c + 16 * pool * pool * c) * itemsize > 12 * 1024 * 1024


def fused_taps(lo, size, extent: int, pool: int):
    """Per roi and bin, the four cells of one axis a bin can weigh and their
    weights (zero for a repeated cell or one off the map)."""
    grid = ((torch.arange(2 * pool, dtype=torch.float32) + 0.5) / (2 * pool)).to(lo.device)
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


def roi_align_bound_s(feat_shape, itemsize: int, rois, stride: int = 16, pool: int = 7) -> float:
    """One ROI-align call: the feature cells its rois' taps touch, the rois
    and the output moved once; two float32 operations a channel for every
    tap of the two contractions these rois have."""
    h, w, c = feat_shape
    r = rois.shape[0]
    scaled = rois.float() * (1.0 / stride)
    cells, live = [], []
    for lo, hi, extent in ((1, 3, h), (0, 2, w)):
        cl, wt = fused_taps(scaled[:, lo], (scaled[:, hi] - scaled[:, lo]).clamp(min=1.0),
                            extent, pool)
        cells.append(cl.reshape(r, -1))
        wdt = torch.bfloat16 if itemsize == 2 else torch.float32
        live.append((wt.to(wdt) != 0).reshape(r, -1))
    touched = torch.zeros(h * w, dtype=torch.bool, device=rois.device)
    idx = cells[0][:, :, None] * w + cells[1][:, None, :]
    touched[idx[live[0][:, :, None] & live[1][:, None, :]]] = True
    n_y, n_x = (m.reshape(r, pool, 4).sum(-1).float() for m in live)
    n_f, n_s = (n_x, n_y) if fused_w_first(h, w, c, itemsize, pool) else (n_y, n_x)
    ops = 2.0 * c * float((n_s.sum(1) * (n_f.sum(1) + pool)).sum())
    nbytes = int(touched.sum()) * c * itemsize + r * 16 + r * pool * pool * c * itemsize
    return bound_s(nbytes, ops, "f32")


def nms_bound_s(n: int) -> float:
    """One NMS stream of ``n`` boxes: boxes, scores and valid flags read
    once, keep flags written once; the IoU of every pair."""
    return bound_s(n * (16 + 4 + 1 + 1), n * (n - 1) // 2 * rs.IOU_OPS, "f32")


def conv1_bound_s(b: int, h: int, w: int, c: int = 64, co: int = 64) -> float:
    """conv1_2, its ReLU and pool1 over a bf16 batch ``[b, h, w, c]``: input,
    weights and bias read once, the pooled output written once."""
    nbytes = 2 * b * h * w * c + 2 * 9 * c * co + 4 * co + 2 * b * (h // 2) * (w // 2) * co
    return bound_s(nbytes, 2.0 * b * h * w * 9 * c * co, "bf16")
