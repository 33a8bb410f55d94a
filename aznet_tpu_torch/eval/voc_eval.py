"""Pure-Python VOC detection AP.

Counterpart of ``aznet_tpu/eval/voc_eval.py``, the VOCdevkit protocol:
greedy matching of score-sorted detections to gt at IoU >= thresh,
difficult gt neither counted nor penalized, duplicates are false positives;
AP via the 11-point (VOC<=2009) or all-point interpolated definitions.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """AP from recall/precision curves (both VOC definitions)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = float(np.max(prec[rec >= t])) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _match_detections(dets_by_img, gt_by_img, difficult_by_img, ovthresh, offset=1.0):
    """Greedy VOC matching. Returns (tp, fp, scores, n_positives)."""
    recs = []
    npos = 0
    for i, gt in enumerate(gt_by_img):
        diff = difficult_by_img[i]
        npos += int((~diff).sum())
    all_scores, all_tp, all_fp = [], [], []
    for i, dets in enumerate(dets_by_img):
        gt = gt_by_img[i]
        diff = difficult_by_img[i]
        taken = np.zeros(gt.shape[0], bool)
        order = np.argsort(-dets[:, 4], kind="stable") if dets.size else []
        for j in order:
            box = dets[j, :4]
            score = dets[j, 4]
            if gt.shape[0]:
                iw = np.minimum(gt[:, 2], box[2]) - np.maximum(gt[:, 0], box[0]) + offset
                ih = np.minimum(gt[:, 3], box[3]) - np.maximum(gt[:, 1], box[1]) + offset
                inter = np.maximum(iw, 0) * np.maximum(ih, 0)
                union = (
                    (gt[:, 2] - gt[:, 0] + offset) * (gt[:, 3] - gt[:, 1] + offset)
                    + (box[2] - box[0] + offset) * (box[3] - box[1] + offset)
                    - inter
                )
                iou = inter / union
                best = int(np.argmax(iou))
                best_iou = iou[best]
            else:
                best_iou = 0.0
                best = -1
            all_scores.append(score)
            if best_iou >= ovthresh:
                if diff[best]:
                    all_tp.append(0)
                    all_fp.append(0)  # difficult: ignored entirely
                elif not taken[best]:
                    taken[best] = True
                    all_tp.append(1)
                    all_fp.append(0)
                else:
                    all_tp.append(0)
                    all_fp.append(1)  # duplicate
            else:
                all_tp.append(0)
                all_fp.append(1)
    return (
        np.asarray(all_tp, np.float64),
        np.asarray(all_fp, np.float64),
        np.asarray(all_scores, np.float64),
        npos,
    )


def _pr_from_matches(tp, fp, scores, npos, use_07_metric):
    if scores.size == 0 or npos == 0:
        return np.zeros(0), np.zeros(0), 0.0
    order = np.argsort(-scores, kind="stable")
    tp, fp = np.cumsum(tp[order]), np.cumsum(fp[order])
    rec = tp / npos
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def voc_eval(results_file: str, roidb: List[dict], image_index: List[str],
             cls_index: int, ovthresh: float = 0.5, use_07_metric: bool = True):
    """Evaluate one class from a VOC-format results file against the roidb."""
    idx_map = {name: i for i, name in enumerate(image_index)}
    dets_by_img: List[list] = [[] for _ in image_index]
    with open(results_file) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            i = idx_map[parts[0]]
            score = float(parts[1])
            box = [float(v) - 1 for v in parts[2:6]]  # back to 0-indexed
            dets_by_img[i].append(box + [score])
    dets_by_img = [np.asarray(d, np.float64).reshape(-1, 5) for d in dets_by_img]
    gt_by_img, diff_by_img = [], []
    for entry in roidb:
        m = entry["gt_classes"] == cls_index
        gt_by_img.append(entry["boxes"][m].astype(np.float64))
        diff = entry.get("difficult")
        diff_by_img.append(
            diff[m] if diff is not None else np.zeros(int(m.sum()), bool)
        )
    tp, fp, scores, npos = _match_detections(
        dets_by_img, gt_by_img, diff_by_img, ovthresh
    )
    return _pr_from_matches(tp, fp, scores, npos, use_07_metric)


def eval_detections_on_roidb(all_boxes, roidb: List[dict], num_classes: int,
                             ovthresh: float = 0.5,
                             use_07_metric: bool = False) -> Dict[str, float]:
    """In-memory AP eval: ``all_boxes[cls][img] = [N, 5]`` dets."""
    aps = {}
    for c in range(1, num_classes):
        dets_by_img = [np.asarray(all_boxes[c][i], np.float64).reshape(-1, 5)
                       for i in range(len(roidb))]
        gt_by_img, diff_by_img = [], []
        for entry in roidb:
            m = entry["gt_classes"] == c
            gt_by_img.append(entry["boxes"][m].astype(np.float64))
            diff = entry.get("difficult")
            diff_by_img.append(
                diff[m] if diff is not None else np.zeros(int(m.sum()), bool)
            )
        tp, fp, scores, npos = _match_detections(
            dets_by_img, gt_by_img, diff_by_img, ovthresh
        )
        _, _, ap = _pr_from_matches(tp, fp, scores, npos, use_07_metric)
        aps[f"class_{c}"] = ap
    aps["mAP"] = float(np.mean([v for k, v in aps.items() if k != "mAP"])) if aps else 0.0
    return aps
