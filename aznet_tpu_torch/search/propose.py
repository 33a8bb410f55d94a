"""Adjacency-and-zoom search over one image's features
(``aznet_tpu/search/propose.py::az_search``).

Per level: the head on the padded frontier, decode K adjacency candidates
per region, divide the regions whose zoom score passes into 5 children, and
keep the top ``next_cap`` children by parent zoom. The early levels, whose
lossless capacity is below FRONTIER_CAP, run at their own shapes; the
steady-state tail stops when no frontier row is valid. Every level writes
its candidates into one buffer at fixed rows (:func:`candidate_starts`);
they are capped at CAND_BUF by score and go through exact greedy NMS to the
top NUM_PROPOSALS.

After the head, a level is :func:`level_step` (plain PyTorch, on the CPU)
or, for features on the card, one launch of ``csrc/search_level.cu``
(``ops/cuda/search_level_kernel.py``), equal to it bit for bit. Likewise the
search's seed (:func:`seed_plain` / :func:`seed_cuda`) and its selection
(:func:`select_plain` / :func:`select_cuda`): on the card one launch before
the first level and two around the NMS kernel (``csrc/search_select.cu``).

Spans (``utils/profiling.py``, recorded only under ``torch.profiler``): a
``search.level`` per level run (``level``, and ``rows``, the padded frontier
rows the head evaluates), a ``search.sync`` around each host read of the
card (the tail's frontier check), and ``search.select`` around the
candidate cap and NMS.

Two sentinels, as in the reference: the search pads scores with the finite
``NEG_INF = -1e30`` (no inf - inf hazards), while NMS masks with -inf.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from aznet_tpu_torch.config import SearchConfig
from aznet_tpu_torch.ops.boxes import bbox_transform_inv, clip_boxes
from aznet_tpu_torch.ops.cuda.search_level_kernel import search_level_cuda
from aznet_tpu_torch.ops.cuda.search_select_kernel import (search_cap_cuda, search_seed_cuda,
                                                           search_topk_cuda)
from aznet_tpu_torch.ops.nms import nms_mask, nms_topk
from aznet_tpu_torch.ops.topk import top_k
from aznet_tpu_torch.search.templates import (
    NUM_DIVISIONS,
    _apply_normalized,
    adjacency_templates_np,
    division_table,
    divide_regions,
    template_boxes,
)
from aznet_tpu_torch.utils import profiling

NEG_INF = -1e30


def seed_count(seed_levels: int) -> int:
    """Number of initial frontier regions: 1 + 5 + 25 + ..."""
    return sum(NUM_DIVISIONS ** lvl for lvl in range(seed_levels + 1))


def frontier_schedule(scfg: SearchConfig) -> Tuple[int, ...]:
    """Lossless per-level frontier capacities, multiples of 8 capped at
    FRONTIER_CAP (level i holds at most seed_count * 5**i regions)."""
    n = seed_count(scfg.SEED_LEVELS)
    caps = []
    for _ in range(scfg.MAX_LEVELS):
        caps.append(min(scfg.FRONTIER_CAP, max(8, -(-n // 8) * 8)))
        n *= NUM_DIVISIONS
    return tuple(caps)


def init_frontier(im_h, im_w, scfg: SearchConfig, offset: float = 1.0,
                  cap: int | None = None):
    """The whole image plus SEED_LEVELS of its divisions, padded to ``cap``
    (default FRONTIER_CAP). ``im_h``/``im_w`` may be 0-d tensors, whose
    device the result takes. Returns ``(boxes [R, 4], valid [R])``."""
    r = scfg.FRONTIER_CAP if cap is None else cap
    device = next((v.device for v in (im_h, im_w) if isinstance(v, torch.Tensor)), None)
    im_h = torch.as_tensor(im_h, dtype=torch.float32, device=device)
    im_w = torch.as_tensor(im_w, dtype=torch.float32, device=device)
    zero = torch.zeros_like(im_w)
    current = torch.stack([zero, zero, im_w - offset, im_h - offset])[None]
    seeds = [current]
    for _ in range(scfg.SEED_LEVELS):
        current = divide_regions(current, scfg.DIV_OVERLAP, offset).reshape(-1, 4)
        seeds.append(current)
    boxes = torch.cat(seeds)
    n = boxes.shape[0]
    if n > r:
        raise ValueError(f"SEED_LEVELS={scfg.SEED_LEVELS} yields {n} seed regions "
                         f"> FRONTIER_CAP={r}")
    boxes = torch.nn.functional.pad(boxes, (0, 0, 0, r - n))
    return boxes, torch.arange(r, device=device) < n




def candidate_starts(scfg: SearchConfig, num_templates: int = 11):
    """``(starts, total)``: the candidate buffer's first row of each level's
    R * K candidates, and its length. The levels in order at their frontier
    widths (the unrolled prefix at its own, the tail at FRONTIER_CAP), which
    is the order and layout in which the reference concatenates them."""
    starts, total = [], 0
    for cap in frontier_schedule(scfg):
        starts.append(total)
        total += cap * num_templates
    return tuple(starts), total


class LevelConsts(NamedTuple):
    """What every level of one search shares (:func:`level_consts`)."""

    templates: torch.Tensor  # [K, 4] float32 on the features' device
    divisions: torch.Tensor  # [5, 4] float32 on the features' device
    templates_np: np.ndarray  # the same tables as NumPy, which the kernel
    divisions_np: np.ndarray  # takes by value
    extent: torch.Tensor  # [2] float32 on the features' device: the valid (h, w)
    offset: float
    zoom_thresh: float
    min_size: float
    clip: float | None  # BBOX_XFORM_CLIP


@functools.lru_cache(maxsize=None)
def _device_tables(num_templates: int, div_overlap: float, device: torch.device):
    """The template and division tables on ``device``, copied once a process
    (as normal tensors, though the first search may run in inference mode)."""
    with torch.inference_mode(False):
        return (torch.as_tensor(adjacency_templates_np(num_templates), device=device),
                torch.as_tensor(division_table(div_overlap), device=device))


def level_consts(scfg: SearchConfig, num_templates: int, extent: torch.Tensor,
                 offset: float = 1.0) -> LevelConsts:
    """The constants of one search whose valid ``extent [2]`` (h, w) lies on
    the features' device."""
    templates, divisions = _device_tables(num_templates, scfg.DIV_OVERLAP, extent.device)
    return LevelConsts(templates, divisions, adjacency_templates_np(num_templates),
                       division_table(scfg.DIV_OVERLAP), extent, offset, scfg.ZOOM_THRESH,
                       scfg.MIN_SIZE, scfg.BBOX_XFORM_CLIP)


def level_step(out: dict, f_boxes, f_valid, next_cap: int, c: LevelConsts):
    """One level after the head, the plain version: the head's logits
    ``out`` on the frontier ``f_boxes [R, 4]`` / ``f_valid [R]`` -> the
    candidates ``(boxes [R*K, 4], scores [R*K])`` and the next frontier
    ``(boxes [next_cap, 4], valid [next_cap])``."""
    im_hw = (c.extent[0], c.extent[1])
    zoom_p = torch.sigmoid(out["zoom"])
    adj_p = torch.sigmoid(out["adj_score"])
    anchors = template_boxes(f_boxes, c.templates, c.offset)
    boxes = bbox_transform_inv(anchors, out["adj_delta"], c.offset, clip=c.clip)
    boxes = clip_boxes(boxes, im_hw, c.offset)
    scores = torch.where(f_valid[:, None], adj_p, NEG_INF)

    children = _apply_normalized(f_boxes, c.divisions, c.offset)  # [R, 5, 4]
    cw = children[..., 2] - children[..., 0] + c.offset
    ch = children[..., 3] - children[..., 1] + c.offset
    parent_ok = f_valid & (zoom_p > c.zoom_thresh)
    child_ok = parent_ok[:, None] & (torch.minimum(cw, ch) >= c.min_size)
    priority = torch.where(child_ok, zoom_p[:, None], NEG_INF).reshape(-1)
    cboxes = children.reshape(-1, 4)
    if next_cap > priority.shape[0]:  # the schedule grows at most 5x
        pad = next_cap - priority.shape[0]
        priority = torch.nn.functional.pad(priority, (0, pad), value=NEG_INF)
        cboxes = torch.nn.functional.pad(cboxes, (0, 0, 0, pad))
    # Ties are certain here (a parent's five children share its zoom
    # score); top_k keeps the lower index first, as jax.lax.top_k.
    top_p, top_i = top_k(priority, next_cap)
    return boxes.reshape(-1, 4), scores.reshape(-1), cboxes[top_i], top_p > NEG_INF


def level_plain(out: dict, f_boxes, f_valid, next_cap: int, c: LevelConsts,
                cand_boxes, cand_scores, start: int):
    """:func:`level_step` with its candidates written into rows ``start ..``
    of the candidate buffers; returns the next frontier."""
    boxes, scores, next_boxes, next_valid = level_step(out, f_boxes, f_valid, next_cap, c)
    cand_boxes[start:start + boxes.shape[0]] = boxes
    cand_scores[start:start + scores.shape[0]] = scores
    return next_boxes, next_valid


def level_cuda(out: dict, f_boxes, f_valid, next_cap: int, c: LevelConsts,
               cand_boxes, cand_scores, start: int):
    """:func:`level_plain` on the card: one launch of ``csrc/search_level.cu``."""
    return search_level_cuda(out["zoom"], out["adj_score"], out["adj_delta"], f_boxes, f_valid,
                             c.extent, c.templates_np, c.divisions_np, next_cap, cand_boxes,
                             cand_scores, start, offset=c.offset, zoom_thresh=c.zoom_thresh,
                             min_size=c.min_size, clip=c.clip, neg_inf=NEG_INF)


def seed_plain(im_hw, scfg: SearchConfig, offset: float, cap: int, total: int,
               device: torch.device):
    """A search's start, the plain version: ``(extent [2], f_boxes [cap, 4],
    f_valid [cap], cand_boxes [total, 4], cand_scores [total])``, the valid
    ``(h, w)`` as float32, the seed frontier (:func:`init_frontier`) and the
    candidate buffers (zero boxes, NEG_INF scores), on ``device``."""
    im_h = torch.as_tensor(im_hw[0], dtype=torch.float32, device=device)
    im_w = torch.as_tensor(im_hw[1], dtype=torch.float32, device=device)
    cand_boxes = torch.zeros((total, 4), dtype=torch.float32, device=device)
    cand_scores = torch.full((total,), NEG_INF, dtype=torch.float32, device=device)
    f_boxes, f_valid = init_frontier(im_h, im_w, scfg, offset, cap=cap)
    return torch.stack([im_h, im_w]), f_boxes, f_valid, cand_boxes, cand_scores


def seed_cuda(im_hw, scfg: SearchConfig, offset: float, cap: int, total: int,
              device: torch.device):
    """:func:`seed_plain` on the card: one launch of ``csrc/search_select.cu``."""
    n = seed_count(scfg.SEED_LEVELS)
    if n > cap:
        raise ValueError(f"SEED_LEVELS={scfg.SEED_LEVELS} yields {n} seed regions "
                         f"> FRONTIER_CAP={cap}")
    return search_seed_cuda(im_hw[0], im_hw[1], division_table(scfg.DIV_OVERLAP), n, cap,
                            total, offset=offset, neg_inf=NEG_INF, device=device)


def select_plain(c_boxes, c_scores, scfg: SearchConfig, offset: float):
    """The search's selection, the plain version: the candidates capped at
    CAND_BUF by score (the one lossy step), those under CONF_THRESH dropped,
    exact greedy NMS, the top NUM_PROPOSALS: ``(boxes, scores, valid)``."""
    if c_scores.shape[0] > scfg.CAND_BUF:
        c_scores, idx = top_k(c_scores, scfg.CAND_BUF)
        c_boxes = c_boxes[idx]

    final_scores = torch.where(c_scores >= scfg.CONF_THRESH, c_scores, NEG_INF)
    live = final_scores > NEG_INF
    return nms_topk(c_boxes, final_scores, scfg.NMS_THRESH, scfg.NUM_PROPOSALS,
                    valid=live, offset=offset)


def select_cuda(c_boxes, c_scores, scfg: SearchConfig, offset: float):
    """:func:`select_plain` on the card: a launch of ``csrc/search_select.cu``
    for the cap and threshold, the NMS kernel, a launch for the top-k."""
    boxes, final, live = search_cap_cuda(c_boxes, c_scores, scfg.CAND_BUF, scfg.CONF_THRESH,
                                         NEG_INF)
    keep = nms_mask(boxes, final, scfg.NMS_THRESH, valid=live, offset=offset)
    return search_topk_cuda(keep, final, boxes, scfg.NUM_PROPOSALS)


def search_candidates(roi_forward: Callable, feat: torch.Tensor, im_hw, scfg: SearchConfig,
                      num_templates: int = 11, offset: float = 1.0,
                      collect_frontier: bool = False):
    """Every level of the search over ``feat``: ``(cand_boxes [T, 4],
    cand_scores [T])`` in the layout of :func:`candidate_starts` (the slots
    of levels not run stay zero boxes at NEG_INF), then, with
    ``collect_frontier``, ``visited`` and ``visited_valid`` as
    :func:`az_search` returns them. The seed and a level after the head are
    :func:`seed_cuda` and :func:`level_cuda` where ``feat`` is a CUDA
    tensor, else :func:`seed_plain` and :func:`level_plain`."""
    dev = feat.device
    r_cap = scfg.FRONTIER_CAP
    sched = frontier_schedule(scfg)
    starts, total = candidate_starts(scfg, num_templates)
    seed, step = (seed_cuda, level_cuda) if feat.is_cuda else (seed_plain, level_plain)
    extent, f_boxes, f_valid, cand_boxes, cand_scores = seed(im_hw, scfg, offset, sched[0],
                                                             total, dev)
    consts = level_consts(scfg, num_templates, extent, offset)
    if collect_frontier:
        vis_b = torch.zeros((scfg.MAX_LEVELS, r_cap, 4), dtype=torch.float32, device=dev)
        vis_v = torch.zeros((scfg.MAX_LEVELS, r_cap), dtype=torch.bool, device=dev)
    for lvl, cap in enumerate(sched):
        # The early levels below FRONTIER_CAP run unconditionally; the
        # steady-state tail stops when no frontier row is valid.
        if cap == r_cap:
            with profiling.span("search.sync"):
                any_valid = bool(f_valid.any())
            if not any_valid:
                break
        next_cap = sched[lvl + 1] if lvl + 1 < len(sched) else cap
        if collect_frontier:
            vis_b[lvl, :cap] = f_boxes
            vis_v[lvl, :cap] = f_valid
        with profiling.span("search.level", level=lvl, rows=cap):
            out = roi_forward(feat, f_boxes)
            f_boxes, f_valid = step(out, f_boxes, f_valid, next_cap, consts,
                                    cand_boxes, cand_scores, starts[lvl])
    if collect_frontier:
        return cand_boxes, cand_scores, vis_b.reshape(-1, 4), vis_v.reshape(-1)
    return cand_boxes, cand_scores


def az_search(roi_forward: Callable, feat: torch.Tensor, im_hw, scfg: SearchConfig,
              num_templates: int = 11, offset: float = 1.0,
              collect_frontier: bool = False):
    """Zoom search over ``feat [h, w, C]`` of one image whose valid scaled
    extents are ``im_hw``. ``roi_forward(feat, rois [R, 4])`` returns the
    head's logits dict. Returns ``(boxes [N, 4], scores [N], valid [N])``,
    N = NUM_PROPOSALS, in the scaled image's coordinates.

    ``collect_frontier`` (hard-region mining, ``train/mining.py``) also
    returns every frontier region the head evaluated, ``visited
    [MAX_LEVELS * FRONTIER_CAP, 4]`` and ``visited_valid``, in the
    reference's layout: one block of FRONTIER_CAP rows per level (a level of
    the unrolled prefix padded with zero rows), zero from the level where the
    frontier emptied. The selection is :func:`select_cuda` for candidates on
    the card, else :func:`select_plain`."""
    c_boxes, c_scores, *visited = search_candidates(
        roi_forward, feat, im_hw, scfg, num_templates, offset, collect_frontier)
    with profiling.span("search.select"):
        select = select_cuda if c_scores.is_cuda else select_plain
        out = select(c_boxes, c_scores, scfg, offset)
    return (*out, *visited)
