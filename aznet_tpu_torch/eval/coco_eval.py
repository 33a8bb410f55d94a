"""COCO-protocol detection metrics: AP@[.5:.95], per-area AP, AR@maxDets.

Counterpart of ``aznet_tpu/eval/coco_eval.py``: the standard COCO protocol
(pycocotools ``COCOeval`` for bbox) in NumPy and the host library, with no
pycocotools dependency:

  - IoU thresholds 0.50:0.05:0.95 (10), recall grid 0:0.01:1 (101 points)
  - per (class, image): greedy matching in detection-score order; each
    detection takes the not-yet-matched gt with the highest IoU >= t
  - ignored gts (crowds, or outside the area range) absorb matches without
    counting; unmatched detections outside the area range are ignored, not
    FPs; a taken non-crowd gt is skipped (even if ignored), while a crowd
    gt stays matchable and can absorb any number of detections
  - crowd IoU uses the pycocotools convention: union = detection area
    (intersection-over-detection), since a crowd box is a region, not an
    instance
  - precision is made monotonically non-increasing from the right, then
    sampled at the recall grid; AP = mean over classes (with gt) and IoUs
  - AR@K = mean over classes/IoUs of max recall with <= K dets per image

Box convention: this framework stores COCO boxes inclusively
(``x2 = x + w - 1``, see data/coco.py), so areas/IoU here use ``offset=1``
to recover the original continuous widths. Pass ``offset=0`` for raw
continuous xyxy boxes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from aznet_tpu_torch.utils import native

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)  # .5 ... .95
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, float(1e10)),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, float(1e10)),
}


def _iou_matrix(dets: np.ndarray, gts: np.ndarray, crowd: np.ndarray,
                offset: float) -> np.ndarray:
    """[D, G] IoU; for crowd gt columns, union = det area (pycocotools)."""
    if dets.size == 0 or gts.size == 0:
        return np.zeros((dets.shape[0], gts.shape[0]))
    iw = (np.minimum(dets[:, None, 2], gts[None, :, 2])
          - np.maximum(dets[:, None, 0], gts[None, :, 0]) + offset)
    ih = (np.minimum(dets[:, None, 3], gts[None, :, 3])
          - np.maximum(dets[:, None, 1], gts[None, :, 1]) + offset)
    inter = np.maximum(iw, 0) * np.maximum(ih, 0)
    area_d = ((dets[:, 2] - dets[:, 0] + offset)
              * (dets[:, 3] - dets[:, 1] + offset))[:, None]
    area_g = ((gts[:, 2] - gts[:, 0] + offset)
              * (gts[:, 3] - gts[:, 1] + offset))[None, :]
    union = np.where(crowd[None, :], area_d, area_d + area_g - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _match_image_ref(ious, gt_ignore, crowd, iou_thrs):
    """Readable sequential transcription of pycocotools ``evaluateImg``;
    the oracle for :func:`_match_image`. Same contract as ``_match_image``."""
    n_t = len(iou_thrs)
    n_d, n_g = ious.shape
    dtm = np.zeros((n_t, n_d), bool)
    dtig = np.zeros((n_t, n_d), bool)
    if n_d == 0 or n_g == 0:
        return dtm, dtig
    not_ig = ~gt_ignore

    def _pick(row, mask, thr):
        """Last index of the max of row[mask] if it clears thr, else -1."""
        cand = np.where(mask, row, -1.0)
        best = cand.max()
        if best < thr:
            return -1
        return n_g - 1 - int(np.argmax(cand[::-1] == best))

    for ti, t in enumerate(iou_thrs):
        thr = min(t, 1.0 - 1e-10)
        gtaken = np.zeros(n_g, bool)
        for d in range(n_d):
            avail = ~gtaken | crowd
            best = _pick(ious[d], avail & not_ig, thr)
            if best < 0:
                best = _pick(ious[d], avail & gt_ignore, thr)
            if best >= 0:
                gtaken[best] = True
                dtm[ti, d] = True
                dtig[ti, d] = gt_ignore[best]
    return dtm, dtig


def _match_image(ious, gt_ignore, crowd, iou_thrs):
    """pycocotools ``evaluateImg`` for one (class, image, area-range).

    ious: [D, G] with detections score-sorted desc and gts sorted
    ignored-last (the same ordering as ``gt_ignore``/``crowd``). Returns
    (dt_match [T, D] bool, dt_ignore [T, D] bool) per IoU threshold.

    Semantics mirrored from pycocotools: a taken non-crowd gt is skipped
    (crowds stay matchable forever); a detection prefers the best-IoU
    non-ignored gt, falling back to ignored gts only when no non-ignored
    one clears the threshold; score ties resolve to the LAST qualifying gt
    in scan order (pycocotools updates on ``iou >= best``).

    Runs the host library's matcher (``csrc/host.cc::az_coco_match``);
    :func:`_match_image_np` and :func:`_match_image_ref` are its plain
    versions.
    """
    n_t = len(iou_thrs)
    n_d, n_g = ious.shape
    if n_d == 0 or n_g == 0:
        return (np.zeros((n_t, n_d), bool), np.zeros((n_t, n_d), bool))
    thrs = np.minimum(np.asarray(iou_thrs, np.float64), 1.0 - 1e-10)  # [T]
    return native.coco_match(ious, gt_ignore, crowd, thrs)


def _match_image_np(ious, gt_ignore, crowd, thrs):
    """Vectorized NumPy matcher (contract of :func:`_match_image`; ``thrs``
    pre-clamped).

    Greedy matching is sequential over detections only where two of them
    want the SAME gt — a detection's preference is stable while its chosen
    gt remains available (removing other gts cannot change its argmax), so
    the maximal prefix of not-yet-resolved detections with pairwise-
    distinct non-crowd preferences finalizes in one shot. This runs
    "auction" rounds, each fully vectorized over the T=10 thresholds AND
    all detections ([T, D, G] tensor ops): compute every unresolved
    detection's preferred gt, finalize per threshold up to the first
    preference conflict, repeat. Detections whose best IoU over ALL gts
    clears no threshold prune upfront (they can never match; at real-COCO
    scale most false positives die here). Conflicts are rare after NMS, so
    rounds ~ O(few); outputs are identical to the sequential oracle
    (:func:`_match_image_ref`).
    """
    n_t = len(thrs)
    n_d, n_g = ious.shape
    dtm = np.zeros((n_t, n_d), bool)
    dtig = np.zeros((n_t, n_d), bool)
    # Prune detections that cannot match at the loosest threshold.
    live = np.flatnonzero(ious.max(axis=1) >= thrs.min())
    if live.size == 0:
        return dtm, dtig
    iou_l = ious[live][None, :, :]  # [1, Dl, G]
    n_l = live.size
    not_ig = (~gt_ignore)[None, None, :]
    ig = gt_ignore[None, None, :]
    thrs_c = thrs[:, None]  # [T, 1]

    gtaken = np.zeros((n_t, n_g), bool)
    # ptr[t]: live detections before this index are finalized for t.
    ptr = np.zeros(n_t, dtype=int)
    d_iota = np.arange(n_l)
    while (ptr < n_l).any():
        avail = (~gtaken | crowd[None, :])[:, None, :]  # [T, 1, G]
        # Stage 1: best available non-ignored gt; ties keep the LAST gt
        # (pycocotools updates its running best on >=).
        cand = np.where(avail & not_ig, iou_l, -1.0)  # [T, Dl, G]
        best = cand.max(axis=2)
        ok = best >= thrs_c
        pref = n_g - 1 - np.argmax(cand[:, :, ::-1] == best[..., None],
                                   axis=2)
        # Stage 2: ignored-gt fallback where stage 1 found nothing.
        cand2 = np.where(avail & ig, iou_l, -1.0)
        best2 = cand2.max(axis=2)
        ok2 = ~ok & (best2 >= thrs_c)
        pref2 = n_g - 1 - np.argmax(cand2[:, :, ::-1] == best2[..., None],
                                    axis=2)
        pref = np.where(ok2, pref2, pref)
        matched = ok | ok2  # [T, Dl]

        # Finalize, per threshold, the maximal unresolved prefix whose
        # matched NON-CROWD preferences are pairwise distinct (crowds
        # absorb unlimited detections — never a conflict). The first
        # unresolved detection always finalizes, so every round advances.
        unres = d_iota[None, :] >= ptr[:, None]  # [T, Dl]
        contested = matched & unres & ~crowd[pref]
        # dup[t, d] = some earlier contested det in this round wants the
        # same gt. [T, Dl, Dl] compare; Dl is <= a few hundred post-NMS.
        same = (pref[:, :, None] == pref[:, None, :])  # [T, d, e]
        earlier = d_iota[None, :] < d_iota[:, None]  # [d, e] e < d
        dup = (same & earlier[None] & contested[:, None, :]
               & contested[:, :, None]).any(axis=2)  # [T, Dl]
        blocked = dup & unres
        stop = np.where(blocked.any(axis=1),
                        blocked.argmax(axis=1), n_l)  # [T] first conflict
        final = unres & (d_iota[None, :] < stop[:, None])  # [T, Dl]
        take = final & matched
        t_idx, d_idx = np.nonzero(take)
        g_idx = pref[t_idx, d_idx]
        gtaken[t_idx, g_idx] = True
        dtm[t_idx, live[d_idx]] = True
        dtig[t_idx, live[d_idx]] = gt_ignore[g_idx]
        ptr = stop
    return dtm, dtig


def coco_eval(all_boxes, roidb: List[dict], num_classes: int,
              max_dets: Sequence[int] = (1, 10, 100),
              offset: float = 1.0) -> Dict[str, float]:
    """COCO AP/AR from in-memory detections.

    ``all_boxes[cls][img] = [N, 5]`` (the framework's standard layout, same
    as :func:`aznet_tpu_torch.eval.voc_eval.eval_detections_on_roidb`).

    Returns {"AP", "AP50", "AP75", "AP_small", "AP_medium", "AP_large",
    "AR@1", "AR@10", "AR@100", "class_<c>_AP"}.
    """
    n_img = len(roidb)
    top_k = max(max_dets)
    iou_thrs = IOU_THRS

    # Pre-sort gt per (img, cls); ignored-last ordering is assumed by the
    # matcher. Ignore flags are area-range dependent, so store areas.
    results: Dict[str, Dict] = {}
    per_class_ap = {}
    ap_by_range = {k: [] for k in AREA_RANGES}
    ar_by_k = {k: [] for k in max_dets}

    for c in range(1, num_classes):
        # Gather per-image gt/crowd flags/detections for this class and
        # compute the IoU matrix ONCE per (class, image); the area-range
        # loop below only reorders its columns (ignored-last) per range.
        gt_img, crowd_img, det_img, iou_img = [], [], [], []
        for i in range(n_img):
            m = roidb[i]["gt_classes"] == c
            gts = roidb[i]["boxes"][m].astype(np.float64)
            cr = roidb[i].get("crowd")
            cr = (np.asarray(cr, bool)[m] if cr is not None
                  else np.zeros(gts.shape[0], bool))
            dets = np.asarray(all_boxes[c][i], np.float64).reshape(-1, 5)
            order = np.argsort(-dets[:, 4], kind="stable")[:top_k]
            dets = dets[order]
            gt_img.append(gts)
            crowd_img.append(cr)
            det_img.append(dets)
            iou_img.append(_iou_matrix(dets[:, :4], gts, cr, offset))

        for rng_name, (amin, amax) in AREA_RANGES.items():
            # Match every image at every IoU threshold for this range.
            per_img = []
            npos = 0
            for i in range(n_img):
                gts, dets, crowd = gt_img[i], det_img[i], crowd_img[i]
                g_area = ((gts[:, 2] - gts[:, 0] + offset)
                          * (gts[:, 3] - gts[:, 1] + offset))
                # Crowds are ignore regions at EVERY area range.
                g_ig = crowd | (g_area < amin) | (g_area > amax)
                ord_g = np.argsort(g_ig, kind="stable")  # ignored last
                g_ig, crowd_s = g_ig[ord_g], crowd[ord_g]
                npos += int((~g_ig).sum())
                dtm, dtig = _match_image(
                    iou_img[i][:, ord_g], g_ig, crowd_s, iou_thrs)
                d_area = ((dets[:, 2] - dets[:, 0] + offset)
                          * (dets[:, 3] - dets[:, 1] + offset))
                out_rng = (d_area < amin) | (d_area > amax)
                # unmatched out-of-range dets are ignored, not FPs
                dtig = dtig | (~dtm & out_rng[None, :])
                per_img.append((dets[:, 4], dtm, dtig))
            if npos == 0:
                continue

            for k in (max_dets if rng_name == "all" else (top_k,)):
                scores = np.concatenate([p[0][:k] for p in per_img])
                dtm = np.concatenate([p[1][:, :k] for p in per_img], axis=1)
                dtig = np.concatenate([p[2][:, :k] for p in per_img], axis=1)
                order = np.argsort(-scores, kind="mergesort")
                dtm, dtig = dtm[:, order], dtig[:, order]
                tps = dtm & ~dtig
                fps = ~dtm & ~dtig
                tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
                fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
                rec = tp_cum / npos
                prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
                if rng_name == "all":
                    ar_by_k[k].append(
                        float(np.mean(rec[:, -1])) if rec.size else 0.0)
                if k != top_k:
                    continue
                # precision envelope + 101-point sampling, per IoU thr
                ap_t = np.zeros(len(iou_thrs))
                for ti in range(len(iou_thrs)):
                    p = prec[ti].copy()
                    for j in range(p.size - 1, 0, -1):
                        p[j - 1] = max(p[j - 1], p[j])
                    inds = np.searchsorted(rec[ti], REC_THRS, side="left")
                    q = np.zeros(len(REC_THRS))
                    ok = inds < p.size
                    q[ok] = p[inds[ok]]
                    ap_t[ti] = q.mean()
                ap_by_range[rng_name].append(ap_t)
                if rng_name == "all":
                    per_class_ap[f"class_{c}_AP"] = float(ap_t.mean())

    def _mean(stack):
        return float(np.mean(np.stack(stack))) if stack else float("nan")

    out = {
        "AP": _mean(ap_by_range["all"]),
        "AP_small": _mean(ap_by_range["small"]),
        "AP_medium": _mean(ap_by_range["medium"]),
        "AP_large": _mean(ap_by_range["large"]),
    }
    if ap_by_range["all"]:
        stack = np.stack(ap_by_range["all"])  # [C, T]
        out["AP50"] = float(stack[:, 0].mean())
        out["AP75"] = float(stack[:, 5].mean())
    else:
        out["AP50"] = out["AP75"] = float("nan")
    for k in max_dets:
        out[f"AR@{k}"] = _mean(ar_by_k[k]) if ar_by_k[k] else float("nan")
    out.update(per_class_ap)
    return out
