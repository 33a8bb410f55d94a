"""Plain PyTorch reference of the adjacency-and-zoom search and its NMS.

Written after the AZ-Net paper (arXiv:1512.07711, section 3) with the
conventions of the benchmarked system: Caffe boxes with ``+offset`` widths,
11 adjacency templates and 5 zoom divisions in each region's unit frame, a
frontier per level kept by the parent's zoom probability (ties to the lower
index), candidates capped at ``CAND_BUF`` by score, exact greedy NMS and the
top ``NUM_PROPOSALS``. Every function works on float32 tensors on any device
and imports nothing of the benchmarked program.

``search`` is the whole search over one image's features. Beside its own
proposals it carries, level by level, the regions that any search whose
zoom logits lie within ``band / 2`` of its own could have visited
(``admissible``) and those that every such search visits (``sure``): the
check of ``harness/check.py`` judges a program's proposals against them,
since two sound searches in different precisions part ways where two
regions' zoom scores nearly tie.
"""

from __future__ import annotations

import dataclasses
import math

import torch

NEG_INF = -1e30  # the search's finite score sentinel (NMS masks with -inf)

# Whole region, 4 halves, 4 quadrants, centre, 1.5x context window.
TEMPLATES_11 = (
    (0.00, 0.00, 1.00, 1.00), (0.00, 0.00, 0.50, 1.00), (0.50, 0.00, 1.00, 1.00),
    (0.00, 0.00, 1.00, 0.50), (0.00, 0.50, 1.00, 1.00), (0.00, 0.00, 0.50, 0.50),
    (0.50, 0.00, 1.00, 0.50), (0.00, 0.50, 0.50, 1.00), (0.50, 0.50, 1.00, 1.00),
    (0.25, 0.25, 0.75, 0.75), (-0.25, -0.25, 1.25, 1.25),
)
# Zoom division: 4 quadrants and the centre, at half size.
DIVISIONS = (
    (0.00, 0.00, 0.50, 0.50), (0.50, 0.00, 1.00, 0.50), (0.00, 0.50, 0.50, 1.00),
    (0.50, 0.50, 1.00, 1.00), (0.25, 0.25, 0.75, 0.75),
)
IOU_OPS = 15  # float32 operations per IoU of a box pair


def table(rows, device, div_overlap: float = 0.0) -> torch.Tensor:
    t = torch.tensor(rows, dtype=torch.float32)
    if div_overlap:
        ctr, half = (t[:, :2] + t[:, 2:]) / 2.0, (t[:, 2:] - t[:, :2]) / 2.0 * (1.0 + div_overlap)
        t = torch.cat([ctr - half, ctr + half], 1)
    return t.to(device)


def in_frame(regions, tab, offset: float):
    """Boxes ``tab [K, 4]`` given in each region's unit frame -> ``[..., K, 4]``."""
    w = (regions[..., 2] - regions[..., 0] + offset)[..., None]
    h = (regions[..., 3] - regions[..., 1] + offset)[..., None]
    x1, y1 = regions[..., 0, None], regions[..., 1, None]
    tx1, ty1, tx2, ty2 = tab.unbind(-1)
    return torch.stack([x1 + tx1 * w, y1 + ty1 * h, x1 + tx2 * w - offset,
                        y1 + ty2 * h - offset], -1)


def decode(boxes, deltas, offset: float, clip: float | None = None):
    """Fast R-CNN's box decode of ``deltas [..., 4]`` against ``boxes
    [..., 4]`` (broadcast; ``x2 = ctr + w / 2``, no ``- offset``, as the
    system)."""
    w = boxes[..., 2] - boxes[..., 0] + offset
    h = boxes[..., 3] - boxes[..., 1] + offset
    cx, cy = boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h
    dx, dy, dw, dh = deltas.unbind(-1)
    if clip is not None:
        dw, dh = dw.clamp(-clip, clip), dh.clamp(-clip, clip)
    pcx, pcy = dx * w + cx, dy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], -1)


def clip_to(boxes, h, w, offset: float):
    """``[..., 4]`` boxes clipped to x in [0, w - offset], y in [0, h - offset]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    hi_x, hi_y = w - offset, h - offset
    return torch.stack([torch.minimum(x1.clamp(min=0.0), hi_x), torch.minimum(y1.clamp(min=0.0), hi_y),
                        torch.minimum(x2.clamp(min=0.0), hi_x), torch.minimum(y2.clamp(min=0.0), hi_y)], -1)


def top_k(x: torch.Tensor, k: int):
    """The ``k`` largest float32 entries, descending, ties to the lower index,
    ordered by the float total order (+0 above -0)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    idx = torch.sort(key, descending=True, stable=True)[1][:k]
    return x[idx], idx


def seed_count(seed_levels: int) -> int:
    return sum(len(DIVISIONS) ** lvl for lvl in range(seed_levels + 1))


def frontier_schedule(sear: dict) -> tuple:
    """Per-level frontier capacities: the lossless count rounded up to a
    multiple of 8, capped at ``FRONTIER_CAP``."""
    n, caps = seed_count(sear["SEED_LEVELS"]), []
    for _ in range(sear["MAX_LEVELS"]):
        caps.append(min(sear["FRONTIER_CAP"], max(8, -(-n // 8) * 8)))
        n *= len(DIVISIONS)
    return tuple(caps)


def init_frontier(im_h, im_w, sear: dict, offset: float, cap: int):
    """The whole image and ``SEED_LEVELS`` of its divisions, padded with zero
    rows to ``cap``: ``(boxes [cap, 4], valid [cap])``."""
    zero = torch.zeros_like(im_w)
    current = torch.stack([zero, zero, im_w - offset, im_h - offset])[None]
    divisions = table(DIVISIONS, im_w.device, sear["DIV_OVERLAP"])
    seeds = [current]
    for _ in range(sear["SEED_LEVELS"]):
        current = in_frame(current, divisions, offset).reshape(-1, 4)
        seeds.append(current)
    boxes = torch.cat(seeds)
    n = boxes.shape[0]
    return (torch.nn.functional.pad(boxes, (0, 0, 0, cap - n)),
            torch.arange(cap, device=boxes.device) < n)


def iou_matrix(a, b, offset: float):
    iw = torch.minimum(a[:, None, 2], b[None, :, 2]) - torch.maximum(a[:, None, 0], b[None, :, 0]) + offset
    ih = torch.minimum(a[:, None, 3], b[None, :, 3]) - torch.maximum(a[:, None, 1], b[None, :, 1]) + offset
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    area_a = (a[:, 2] - a[:, 0] + offset) * (a[:, 3] - a[:, 1] + offset)
    area_b = (b[:, 2] - b[:, 0] + offset) * (b[:, 3] - b[:, 1] + offset)
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms_keep(boxes, scores, valid, thresh: float, offset: float):
    """Exact greedy NMS keep mask in the input order: rows by score
    descending (ties to the lower index; +-0 and subnormal scores equal), a
    row kept unless an earlier kept row overlaps it by IoU > ``thresh``;
    rows with ``valid`` false or a -inf score are never kept."""
    s = torch.where(valid, scores, float("-inf"))
    u = s.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where((u & 0x7F800000) == 0, torch.zeros_like(u), u)
    key = 0xFFFFFFFF - (u ^ ((u >> 31) * 0x7FFFFFFF + 0x80000000))
    order = torch.sort(key, stable=True)[1]
    live = s[order] > float("-inf")
    over = iou_matrix(boxes[order], boxes[order], offset) > thresh
    # Greedy in blocks of rows: suppression by the kept rows of earlier
    # blocks at once, then row by row inside the block.
    keep = torch.zeros_like(live)
    n, blk = live.shape[0], 64
    for lo in range(0, n, blk):
        hi = min(lo + blk, n)
        cand = live[lo:hi] & ~(over[lo:hi, :lo] & keep[None, :lo]).any(1)
        if not bool(cand.any()):
            continue
        cand = cand.cpu().numpy()
        sub = over[lo:hi, lo:hi].cpu().numpy()
        for i in range(hi - lo):
            if cand[i]:
                cand[i + 1:] &= ~sub[i, i + 1:]
        keep[lo:hi] = torch.from_numpy(cand).to(keep.device)
    return torch.zeros_like(keep).scatter_(0, order, keep)


def finish(cand_boxes, cand_scores, sear: dict, offset: float):
    """The candidate cap, the confidence threshold, NMS and the top
    ``NUM_PROPOSALS``: ``(boxes [N, 4], scores [N], valid [N], index [N])``,
    zeros past the kept rows; ``index`` is each row's candidate."""
    source = torch.arange(cand_scores.shape[0], device=cand_scores.device)
    if cand_scores.shape[0] > sear["CAND_BUF"]:
        cand_scores, source = top_k(cand_scores, sear["CAND_BUF"])
        cand_boxes = cand_boxes[source]
    scores = torch.where(cand_scores >= sear["CONF_THRESH"], cand_scores, NEG_INF)
    keep = nms_keep(cand_boxes, scores, scores > NEG_INF, sear["NMS_THRESH"], offset)
    kept = torch.where(keep, scores, float("-inf"))
    n = sear["NUM_PROPOSALS"]
    k = min(n, kept.shape[0])
    top, idx = top_k(kept, k)
    valid = top > float("-inf")
    source = source[idx]
    boxes = torch.where(valid[:, None], cand_boxes[idx], 0.0)
    top = torch.where(valid, top, 0.0)
    pad = n - k
    return (torch.nn.functional.pad(boxes, (0, 0, 0, pad)), torch.nn.functional.pad(top, (0, pad)),
            torch.nn.functional.pad(valid, (0, pad)), torch.nn.functional.pad(source, (0, pad)))




def level_candidates(regions, out: dict, im_h, im_w, sear: dict, offset: float):
    """One level's candidates from the head's outputs on ``regions [R, 4]``:
    ``(boxes [R, K, 4], scores [R, K], size [R, K, 2])``, ``size`` the width
    and height of the larger of each candidate's template box and its
    decoded box before clipping (the scale of a box's rounding)."""
    k = out["adj_score"].shape[1]
    anchors = in_frame(regions, table(TEMPLATES_11[:k], regions.device), offset)
    raw = decode(anchors, out["adj_delta"].float(), offset, sear["BBOX_XFORM_CLIP"])
    size = torch.maximum(anchors[..., 2:] - anchors[..., :2] + offset, raw[..., 2:] - raw[..., :2])
    return clip_to(raw, im_h, im_w, offset), torch.sigmoid(out["adj_score"].float()), size


def kth(values: torch.Tensor, k: int) -> float:
    """The ``k``-th largest value, -inf where there are fewer."""
    return float(torch.topk(values, k).values[-1]) if values.numel() >= k else float("-inf")


def next_level(regions, own: int, sure, zoom_logits, next_cap: int, sear: dict, offset: float,
               band: float):
    """The next level's regions from ``regions [R, 4]``, whose first ``own``
    rows are this search's own frontier in its order: ``(regions, own,
    sure)``. The own frontier is the top ``next_cap`` children of its rows by
    their parent's zoom probability (children of a parent that passes
    ``ZOOM_THRESH``, shorter side at least ``MIN_SIZE``; ties to the lower
    index). Of any search whose zoom logits lie within ``band / 2`` of
    these, the frontier holds only children whose parent's logit is at least
    the ``next_cap``-th of the sure rows' children less ``band``, and holds
    every sure row's child whose parent's logit passes the ``next_cap``-th of
    all rows' children by more than ``band``: the admissible and the sure
    children. (The order by logit is the order by probability.)"""
    z = zoom_logits.float()
    children = in_frame(regions, table(DIVISIONS, regions.device, sear["DIV_OVERLAP"]), offset)
    side = torch.minimum(children[..., 2] - children[..., 0] + offset,
                         children[..., 3] - children[..., 1] + offset) >= sear["MIN_SIZE"]
    p = torch.sigmoid(z[:own])
    prio = torch.where((p > sear["ZOOM_THRESH"])[:, None] & side[:own], p[:, None],
                       NEG_INF).reshape(-1)
    top_p, top_i = top_k(prio, min(next_cap, prio.numel()))
    own_i = top_i[top_p > NEG_INF]
    thresh = math.log(sear["ZOOM_THRESH"] / (1.0 - sear["ZOOM_THRESH"]))
    zc = z[:, None].expand_as(side)
    maybe = (z > thresh - band)[:, None] & side
    certain = (sure & (z > thresh + band))[:, None] & side
    lo = kth(zc[certain], next_cap) - band
    hi = kth(zc[maybe], next_cap) + band
    admissible = (maybe & (zc >= lo)).reshape(-1)
    admissible[own_i] = False
    idx = torch.cat([own_i, admissible.nonzero()[:, 0]])
    return children.reshape(-1, 4)[idx], own_i.numel(), (certain & (zc > hi)).reshape(-1)[idx]


@dataclasses.dataclass
class Found:
    """What ``search`` finds in one image, in scaled-image coordinates: its
    own proposals, whether each came from a sure region, and every
    admissible region's candidates."""

    boxes: torch.Tensor  # [N, 4]
    scores: torch.Tensor  # [N]
    valid: torch.Tensor  # [N]
    sure: torch.Tensor  # [N]
    cand_boxes: torch.Tensor  # [M, 4]
    cand_scores: torch.Tensor  # [M]
    cand_size: torch.Tensor  # [M, 2]


def search(roi_forward, feat, im_h, im_w, sear: dict, offset: float, band: float = 0.0) -> Found:
    """The whole search over ``feat [h, w, C]`` of one image whose valid
    scaled extents are ``im_h``, ``im_w`` (float32 0-d tensors).
    ``roi_forward(feat, rois)`` returns the head's ``zoom``, ``adj_score``
    and ``adj_delta``. Each level runs the head once over every admissible
    region (``next_level``), its own frontier first; its own candidates go on
    to the cap, NMS and the top ``NUM_PROPOSALS``."""
    sched = frontier_schedule(sear)
    seeds, seed_valid = init_frontier(im_h, im_w, sear, offset, sched[0])
    regions = seeds[seed_valid]
    own, sure = regions.shape[0], torch.ones(regions.shape[0], dtype=torch.bool,
                                             device=regions.device)
    own_b, own_s, own_sure, adm_b, adm_s, adm_size = [], [], [], [], [], []
    for lvl in range(sear["MAX_LEVELS"]):
        if regions.shape[0] == 0:
            break
        out = roi_forward(feat, regions)
        b, s, size = level_candidates(regions, out, im_h, im_w, sear, offset)
        k = s.shape[1]
        own_b.append(b[:own].reshape(-1, 4))
        own_s.append(s[:own].reshape(-1))
        own_sure.append(sure[:own, None].expand(-1, k).reshape(-1))
        adm_b.append(b.reshape(-1, 4))
        adm_s.append(s.reshape(-1))
        adm_size.append(size.reshape(-1, 2))
        next_cap = sched[lvl + 1] if lvl + 1 < len(sched) else sched[lvl]
        regions, own, sure = next_level(regions, own, sure, out["zoom"], next_cap, sear, offset,
                                        band)
    boxes, scores, valid, source = finish(torch.cat(own_b), torch.cat(own_s), sear, offset)
    return Found(boxes, scores, valid, torch.cat(own_sure)[source] & valid, torch.cat(adm_b),
                 torch.cat(adm_s), torch.cat(adm_size))
