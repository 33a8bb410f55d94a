"""How ``correct`` is decided: the plain reference (``reference/``), on the
same raw images and the same float32 weights drawn again from the seed,
judges what the timed path returned, once the window has closed. It reads
the entry's outputs alone, never the program's inner steps.

Proposals (``propose_numbers``). The reference runs the whole search in
float32 (``reference/search.py::search``). The search's choices are
discrete, and where two regions' zoom probabilities nearly tie, a sound
search in bfloat16 may keep the other one. So the reference also carries
every region that a search whose zoom logits lie within half the cell's
``zoom_band`` of its own could visit (admissible), and those that every such
search visits (sure):

- ``proposal_gap``, the worse of two shares. First, each of the program's
  proposals against the nearest candidate of an admissible region: the
  larger of the score's gap and the box's, each side's shift over the
  candidate's width or height; the worst over the proposals. It sees a
  wrong head, decode, division or top-k (a proposal from a region no sound
  search visits) and an altered answer. Second, the share of the
  reference's own proposals from sure regions, in the top half by score,
  that no proposal of the program overlaps at IoU ``MISS_IOU`` or more. NMS
  keeps a box unless a kept higher-scoring box overlaps it by more than its
  threshold (0.7), so a sound search's crowding moves these boxes no
  further. It sees work left out: a level not run, an image not searched,
  the cap or NMS gone wrong. Sound runs read no miss; one number, so that
  the lower-precision control, which fails the first share, holds its
  limit.

Detection (``detect_numbers``): ``cls_gap``, the widest gap of the centred
log class probabilities, and ``box_gap``, of the decoded boxes' shifts from
the given boxes, each as a share of the reference's largest magnitude.
"""

from __future__ import annotations

import math

import torch

from reference import nets, search as rs

MISS_IOU = 0.5
BAND_KEY = "zoom_band"  # a limits file's tolerance of the search, not a compared number


class Reference:
    """The float32 reference of one configuration and network kind."""

    def __init__(self, conf: dict, kind: str, weights: dict, device):
        self.conf, self.kind, self.p, self.device = conf, kind, weights, device
        self.model, self.sear, self.off = conf["MODEL"], conf["SEAR"], conf["BOX_OFFSET"]

    def features(self, image, canvas):
        """``(feat, im_scale 0-d, valid_h, valid_w)`` of a raw uint8 ``image
        [H, W, 3]`` on ``canvas``; ``feat`` the image's map ``[h, w, C]`` or
        its pyramid's levels."""
        test = self.conf["TEST"]
        s = nets.compute_scale(image.shape[0], image.shape[1], test["SCALES"][0],
                               test["MAX_SIZE"])
        blob, vh, vw = nets.preprocess(image.to(self.device), self.conf["PIXEL_MEANS"], s,
                                       canvas[0], canvas[1])
        feat = nets.image_features(nets.trunk(self.model, self.p, blob[None]), 0)
        return feat, torch.tensor(s, dtype=torch.float32, device=self.device), vh, vw

    def roi_forward(self, feat, rois):
        return nets.roi_forward(self.model, self.kind, self.p, feat, rois)


def rel_gap(got, want) -> float:
    """``max|got - want| / max|want|`` (nan where ``got`` is not finite)."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return math.nan
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def worst(*values) -> float:
    """The largest value, nan if any is nan."""
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def _nearest_gap(q_boxes, q_scores, boxes, scores, size, rows: int = 256) -> float:
    """The worst over the rows ``q`` of the distance to the nearest of the
    candidates: ``max(|score gap|, max |x shift| / width, max |y shift| /
    height)``."""
    worst_d = 0.0
    for lo in range(0, q_boxes.shape[0], rows):
        qb, qs = q_boxes[lo:lo + rows, None, :], q_scores[lo:lo + rows, None]
        shift = (qb - boxes[None]).abs()
        d = torch.maximum((qs - scores[None]).abs(), torch.maximum(
            torch.maximum(shift[..., 0], shift[..., 2]) / size[None, :, 0],
            torch.maximum(shift[..., 1], shift[..., 3]) / size[None, :, 1]))
        worst_d = max(worst_d, float(d.min(1).values.max()))
    return worst_d


def propose_numbers(ref: Reference, image, canvas, boxes, scores, valid, band: float) -> dict:
    """``proposal_gap`` of one image (and its two parts): ``boxes [N, 4]``,
    ``scores [N]``, ``valid [N]`` the program's proposals in original
    coordinates."""
    dev = ref.device
    feat, im_scale, vh, vw = ref.features(image, canvas)
    found = rs.search(ref.roi_forward, feat, vh, vw, ref.sear, ref.off, band)
    gb, gs, gv = boxes.to(dev).float(), scores.to(dev).float(), valid.to(dev).bool()
    q_boxes, q_scores = gb[gv], gs[gv]
    if not bool(torch.isfinite(q_boxes).all() & torch.isfinite(q_scores).all()):
        return {"proposal_gap": math.nan}
    gap = _nearest_gap(q_boxes, q_scores, found.cand_boxes / im_scale, found.cand_scores,
                       found.cand_size / im_scale) if q_boxes.shape[0] else 0.0
    top = found.valid & found.sure
    top[found.valid.shape[0] // 2:] = False
    want = found.boxes[top] / im_scale
    if want.shape[0] == 0:
        miss = 0.0
    elif q_boxes.shape[0] == 0:
        miss = 1.0
    else:
        best = rs.iou_matrix(want, q_boxes, ref.off).max(1).values
        miss = float((best < MISS_IOU).float().mean())
    return {"proposal_gap": max(gap, miss), "nearest": gap, "missed": miss}


def detect_numbers(ref: Reference, image, canvas, given, scores, pred) -> dict:
    """``cls_gap`` and ``box_gap`` of one image: ``given [R, 4]`` the boxes
    handed to the program, ``scores [R, K]`` and ``pred [R, 4K]`` its
    class probabilities and decoded boxes."""
    dev, off = ref.device, ref.off
    feat, im_scale, _, _ = ref.features(image, canvas)
    given = given.to(dev).float()
    out = ref.roi_forward(feat, given * im_scale)
    k = out["cls_score"].shape[1]
    h, w = (torch.tensor(float(v), device=dev) for v in image.shape[:2])
    want = rs.clip_to(rs.decode(given[:, None, :], out["bbox_pred"].reshape(-1, k, 4), off), h, w, off)
    lp_want = torch.log_softmax(out["cls_score"], -1)
    lp_got = torch.log(scores.to(dev).float().clamp(min=1e-30))
    centred = [lp - lp.mean(-1, keepdim=True) for lp in (lp_got, lp_want)]
    base = given[:, None, :]
    shift = pred.to(dev).float().reshape(-1, k, 4) - base
    return {"cls_gap": rel_gap(*centred), "box_gap": rel_gap(shift, want - base)}


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, [(name, value, limit)])``: every number at or under its
    limit; a number without a limit, or not finite, fails."""
    rows = [(name, value, limits.get(name)) for name, value in numbers.items()]
    ok = all(lim is not None and math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok and bool(rows), rows
