"""Dataset-level inference drivers: propose-all, recall evaluation, full
detection.

Counterpart of ``aznet_tpu/eval/detection.py`` (the reference's test-tool
loops): per image, ``im_propose`` (recall) or ``im_propose`` + ``im_detect``
+ per-class host NMS (mAP), the detections kept as
``all_boxes[cls][img] = [N, 5]`` for ``imdb.evaluate_detections``.

The batched drivers bucket images by canvas (not by raw size): each bucket
calls the ``api.make_*_padded`` builder once (the port runs eagerly; the
reference's per-bucket compiled program has no counterpart), and its raw
images are zero-padded to the bucket's largest height and width rounded up
to 32. The port pads uint8, where the reference pads float32: the preprocess
casts to float32 first, so the values are the same, and a batch uploads a
quarter of the bytes, once. The tail batch repeats the last real image's
true size and scale, and its padded rows are dropped. Results come to the
host once per batch.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from aznet_tpu_torch import api
from aznet_tpu_torch.eval.recall import recall_table
from aznet_tpu_torch.ops.nms import nms
from aznet_tpu_torch.utils.timer import Timer


def _buckets(imdb, n: int, cfg) -> Dict[tuple, List[int]]:
    """Image indices ``< n`` grouped by canvas."""
    buckets: Dict[tuple, List[int]] = {}
    for i in range(n):
        e = imdb.roidb[i]
        buckets.setdefault(api._canvas_for(e["height"], e["width"], cfg), []).append(i)
    return buckets


def _batches(imdb, idxs: List[int], batch_size: int, cfg, device):
    """Full batches of the bucket ``idxs``: yields ``(chunk, images [B, Hp, Wp,
    3] uint8, src_hw [B, 2] float32, scales [B] float32)``, the tensors on
    ``device``. ``Hp``, ``Wp``: the bucket's largest raw size rounded up to
    32; the tail batch repeats its last real image's size and scale."""
    rup = lambda v, m=32: int(-(-v // m) * m)  # noqa: E731
    hp = rup(max(imdb.roidb[i]["height"] for i in idxs))
    wp = rup(max(imdb.roidb[i]["width"] for i in idxs))
    for start in range(0, len(idxs), batch_size):
        chunk = idxs[start: start + batch_size]
        ims = np.zeros((batch_size, hp, wp, 3), np.uint8)
        src_hw = np.zeros((batch_size, 2), np.float32)
        scales = np.ones((batch_size,), np.float32)
        for j, i in enumerate(chunk):
            im = imdb.image_array(imdb.roidb[i])
            ims[j, : im.shape[0], : im.shape[1]] = im
            src_hw[j] = (im.shape[0], im.shape[1])
            scales[j] = api.compute_scale(im.shape[0], im.shape[1], cfg.TEST.SCALES[0],
                                          cfg.TEST.MAX_SIZE)
        if len(chunk) < batch_size:  # pad the tail batch
            src_hw[len(chunk):] = src_hw[len(chunk) - 1]
            scales[len(chunk):] = scales[len(chunk) - 1]
        yield (chunk, *(torch.from_numpy(a).to(device) for a in (ims, src_hw, scales)))


def _host(*tensors):
    """Tensors to float32 (bool stays bool) NumPy arrays on the host."""
    return tuple((t if t.dtype == torch.bool else t.float()).cpu().numpy() for t in tensors)


def propose_all(net: api.Net, imdb, max_images: Optional[int] = None,
                verbose: bool = False) -> List[np.ndarray]:
    """``im_propose`` over an imdb. Returns per-image ``[N, 5]`` dets."""
    n = min(imdb.num_images, max_images or imdb.num_images)
    timer = Timer()
    out = []
    for i in range(n):
        im = imdb.image_array(imdb.roidb[i])
        timer.tic()
        out.append(api.im_propose(net, im))
        t = timer.toc(average=False)
        if verbose and (i + 1) % 50 == 0:
            print(f"propose {i + 1}/{n} {t:.3f}s (avg {timer.average_time:.3f}s)")
    return out


def propose_all_batched(net: api.Net, imdb, batch_size: int = 16,
                        max_images: Optional[int] = None,
                        verbose: bool = False) -> List[np.ndarray]:
    """Batched ``im_propose`` over an imdb: canvas buckets, full padded
    batches through ``api.make_propose_batch_padded``."""
    cfg = net.cfg
    n = min(imdb.num_images, max_images or imdb.num_images)
    out: List[Optional[np.ndarray]] = [None] * n
    timer = Timer()
    for canvas, idxs in _buckets(imdb, n, cfg).items():
        fn = api.make_propose_batch_padded(net.model, cfg, canvas)
        for chunk, ims, src_hw, scales in _batches(imdb, idxs, batch_size, cfg, net.device):
            timer.tic()
            boxes, scores, valid = _host(*fn(ims, src_hw, scales))
            t = timer.toc(average=False)
            for j, i in enumerate(chunk):
                m = valid[j]
                out[i] = np.concatenate([boxes[j][m], scores[j][m][:, None]], axis=1)
            if verbose:
                print(f"propose_batched {idxs.index(chunk[-1]) + 1}/{len(idxs)} "
                      f"(canvas {canvas}) {t / batch_size * 1000:.1f} ms/img")
    return out  # type: ignore[return-value]


def refine_proposals_batched(frcnn_net: api.Net, imdb, proposals: List[np.ndarray],
                             batch_size: int = 16, verbose: bool = False) -> List[np.ndarray]:
    """A second decode pass over cached AZ proposals: each proposal is
    re-pooled through the Fast R-CNN head and its box replaced by its best
    FOREGROUND class's decoded box (``api.select_class_boxes``); the scores
    and the order stay the AZ search's."""
    cfg = frcnn_net.cfg
    n = len(proposals)
    r_pad = max(int(max((p.shape[0] for p in proposals), default=1)), 1)
    out: List[Optional[np.ndarray]] = [None] * n
    for canvas, idxs in _buckets(imdb, n, cfg).items():
        fn = api.make_detect_batch_padded(frcnn_net.model, cfg, canvas)
        for chunk, ims, src_hw, scales in _batches(imdb, idxs, batch_size, cfg,
                                                   frcnn_net.device):
            boxes_in = np.zeros((batch_size, r_pad, 4), np.float32)
            for j, i in enumerate(chunk):
                boxes_in[j, : proposals[i].shape[0]] = proposals[i][:, :4]
            scores, pred = fn(ims, src_hw, scales, torch.from_numpy(boxes_in).to(frcnn_net.device))
            b, r = scores.shape[:2]
            refined, = _host(api.select_class_boxes(scores.reshape(b * r, -1),
                                                    pred.reshape(b * r, -1)).reshape(b, r, 4))
            for j, i in enumerate(chunk):
                k = proposals[i].shape[0]
                out[i] = np.concatenate([refined[j][:k], proposals[i][:, 4:5]],
                                        axis=1).astype(np.float32)
        if verbose:
            print(f"refined {len(idxs)} images (canvas {canvas})")
    return out  # type: ignore[return-value]


def evaluate_recall(net: api.Net, imdb, top_ks=(100, 300, 1000),
                    max_images: Optional[int] = None, batched: bool = False,
                    batch_size: int = 16, include_difficult: bool = False,
                    refine_net: Optional[api.Net] = None):
    """Proposal recall table over an imdb. The VOC protocol leaves
    'difficult' instances out of the denominator (as the mAP evaluation
    does); ``include_difficult=True`` counts them. ``refine_net``: a Fast
    R-CNN net for :func:`refine_proposals_batched`."""
    n = min(imdb.num_images, max_images or imdb.num_images)
    if batched:
        proposals = propose_all_batched(net, imdb, batch_size=batch_size, max_images=n)
    else:
        proposals = propose_all(net, imdb, max_images=n)
    if refine_net is not None:
        proposals = refine_proposals_batched(refine_net, imdb, proposals,
                                             batch_size=batch_size)
    gts = []
    for i in range(n):
        entry = imdb.roidb[i]
        boxes = entry["boxes"]
        diff = entry.get("difficult")
        if not include_difficult and diff is not None and np.asarray(diff).any():
            boxes = boxes[~np.asarray(diff, bool)]
        gts.append(boxes)
    return recall_table(gts, proposals, top_ks=top_ks)


def _empty_boxes(num_classes: int, n: int):
    return [[np.zeros((0, 5), np.float32) for _ in range(n)] for _ in range(num_classes)]


def _save(all_boxes, cache_file: Optional[str]) -> None:
    if cache_file:
        os.makedirs(os.path.dirname(cache_file) or ".", exist_ok=True)
        with open(cache_file, "wb") as f:
            pickle.dump(all_boxes, f)


def detect_all(az_net: api.Net, frcnn_net: api.Net, imdb, max_images: Optional[int] = None,
               max_per_image: Optional[int] = None, cache_file: Optional[str] = None):
    """The full pipeline per image: AZ proposals, the Fast R-CNN head,
    per-class NMS. Returns ``all_boxes[cls][img] = [N, 5]`` (pickled to
    ``cache_file`` when given)."""
    cfg = frcnn_net.cfg
    n = min(imdb.num_images, max_images or imdb.num_images)
    num_classes = cfg.MODEL.NUM_CLASSES
    max_per_image = max_per_image or cfg.TEST.MAX_PER_IMAGE
    all_boxes = _empty_boxes(num_classes, n)
    for i in range(n):
        im = imdb.image_array(imdb.roidb[i])
        dets = api.im_propose(az_net, im)
        if dets.shape[0] == 0:
            continue
        scores, boxes = api.im_detect(frcnn_net, im, dets[:, :4])
        _store_image_dets(all_boxes, i, scores, boxes, cfg, num_classes, max_per_image)
    _save(all_boxes, cache_file)
    return all_boxes


def _store_image_dets(all_boxes, i, scores, boxes, cfg, num_classes, max_per_image):
    """Per-class threshold, host NMS, then the per-image cap (the reference
    test loop's tail). ``scores [R, K]``, ``boxes [R, 4K]`` float32 NumPy."""
    for c in range(1, num_classes):
        keep = scores[:, c] > cfg.TEST.SCORE_THRESH
        cls_dets = np.concatenate(
            [boxes[keep, 4 * c: 4 * c + 4], scores[keep, c: c + 1]], axis=1).astype(np.float32)
        if cls_dets.shape[0]:
            cls_dets = cls_dets[nms(cls_dets, cfg.TEST.NMS, offset=cfg.BOX_OFFSET)]
        all_boxes[c][i] = cls_dets
    if max_per_image > 0:
        all_scores = np.concatenate([all_boxes[c][i][:, 4] for c in range(1, num_classes)])
        if all_scores.shape[0] > max_per_image:
            thresh = np.sort(all_scores)[-max_per_image]
            for c in range(1, num_classes):
                keep = all_boxes[c][i][:, 4] >= thresh
                all_boxes[c][i] = all_boxes[c][i][keep]


def detect_all_batched(az_net: api.Net, frcnn_net: api.Net, imdb, batch_size: int = 16,
                       max_images: Optional[int] = None, max_per_image: Optional[int] = None,
                       cache_file: Optional[str] = None, verbose: bool = False,
                       fused: Optional[bool] = None):
    """Batched full pipeline: batched AZ propose, then batched Fast R-CNN
    detect; the ``all_boxes`` of :func:`detect_all`.

    ``fused=None`` takes the one-program shared-trunk pipeline
    (:func:`detect_all_fused`) when the nets share their trunk AND their
    TEST geometry is the same (the fused program preprocesses once, with the
    AZ config): the same results with one trunk call instead of two."""
    if fused is None:
        fused = (api.trunks_shared(az_net, frcnn_net)
                 and _test_cfgs_compatible(az_net.cfg, frcnn_net.cfg))
    if fused:
        return detect_all_fused(az_net, frcnn_net, imdb, batch_size=batch_size,
                                max_images=max_images, max_per_image=max_per_image,
                                cache_file=cache_file, verbose=verbose)
    cfg = frcnn_net.cfg
    n = min(imdb.num_images, max_images or imdb.num_images)
    num_classes = cfg.MODEL.NUM_CLASSES
    max_per_image = max_per_image or cfg.TEST.MAX_PER_IMAGE
    all_boxes = _empty_boxes(num_classes, n)
    proposals = propose_all_batched(az_net, imdb, batch_size=batch_size, max_images=n,
                                    verbose=verbose)
    r_pad = max(int(az_net.cfg.SEAR.NUM_PROPOSALS), 1)
    for canvas, idxs in _buckets(imdb, n, cfg).items():
        fn = api.make_detect_batch_padded(frcnn_net.model, cfg, canvas)
        for chunk, ims, src_hw, scales in _batches(imdb, idxs, batch_size, cfg,
                                                   frcnn_net.device):
            boxes_in = np.zeros((batch_size, r_pad, 4), np.float32)
            n_props = [0] * len(chunk)
            for j, i in enumerate(chunk):
                p = proposals[i][:r_pad, :4]
                boxes_in[j, : p.shape[0]] = p
                n_props[j] = p.shape[0]
            scores, pred = _host(*fn(ims, src_hw, scales,
                                     torch.from_numpy(boxes_in).to(frcnn_net.device)))
            for j, i in enumerate(chunk):
                k = n_props[j]
                if k:
                    _store_image_dets(all_boxes, i, scores[j][:k], pred[j][:k], cfg,
                                      num_classes, max_per_image)
    _save(all_boxes, cache_file)
    return all_boxes


def _test_cfgs_compatible(cfg_az, cfg_frcnn) -> bool:
    """True iff the fused single-preprocess program is the two-program path
    (the same blob geometry)."""
    return (tuple(cfg_az.TEST.SCALES) == tuple(cfg_frcnn.TEST.SCALES)
            and cfg_az.TEST.MAX_SIZE == cfg_frcnn.TEST.MAX_SIZE)


def detect_all_fused(az_net: api.Net, frcnn_net: api.Net, imdb, batch_size: int = 16,
                     max_images: Optional[int] = None, max_per_image: Optional[int] = None,
                     cache_file: Optional[str] = None, verbose: bool = False):
    """Shared-trunk end-to-end detection: per canvas bucket ONE program runs
    trunk, AZ search and Fast R-CNN head
    (``api.make_fused_detect_batch_padded``). Needs
    ``api.trunks_shared(az_net, frcnn_net)`` and the same TEST geometry."""
    if not api.trunks_shared(az_net, frcnn_net):
        raise ValueError("detect_all_fused needs share_trunk'd nets (identical trunk params)")
    if not _test_cfgs_compatible(az_net.cfg, frcnn_net.cfg):
        raise ValueError(
            "detect_all_fused preprocesses ONCE with the AZ TEST config; "
            f"FRCNN TEST geometry differs (AZ {az_net.cfg.TEST.SCALES}/"
            f"{az_net.cfg.TEST.MAX_SIZE} vs FRCNN {frcnn_net.cfg.TEST.SCALES}"
            f"/{frcnn_net.cfg.TEST.MAX_SIZE}) — results would not match the "
            "two-program path")
    cfg, cfg_az = frcnn_net.cfg, az_net.cfg
    n = min(imdb.num_images, max_images or imdb.num_images)
    num_classes = cfg.MODEL.NUM_CLASSES
    max_per_image = max_per_image or cfg.TEST.MAX_PER_IMAGE
    all_boxes = _empty_boxes(num_classes, n)
    timer = Timer()
    for canvas, idxs in _buckets(imdb, n, cfg_az).items():
        fn = api.make_fused_detect_batch_padded(az_net.model, frcnn_net.model, cfg_az, cfg,
                                                canvas)
        for chunk, ims, src_hw, scales in _batches(imdb, idxs, batch_size, cfg_az,
                                                   az_net.device):
            timer.tic()
            _, _, valid, scores, pred = fn(ims, src_hw, scales)
            valid, scores, pred = _host(valid, scores, pred)
            t = timer.toc()
            if verbose:
                print(f"# fused batch of {len(chunk)} (canvas {canvas}) "
                      f"{t / batch_size * 1000:.1f} ms/img")
            for j, i in enumerate(chunk):
                k = int(valid[j].sum())
                if k:
                    _store_image_dets(all_boxes, i, scores[j][:k], pred[j][:k], cfg,
                                      num_classes, max_per_image)
    _save(all_boxes, cache_file)
    return all_boxes
