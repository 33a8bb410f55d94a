"""The system under test, behind the three entries the traffic drives:

- ``PortSystem``: the PyTorch and CUDA port (``aznet_tpu_torch``), built
  from a configuration file and the benchmark's weights; the only place the
  harness imports the program.
- ``ReferenceSystem``: the plain reference put in the program's place, its
  operands rounded (``reference/lowp.py``): the lower-precision control
  that the check has to fail."""

from __future__ import annotations

import numpy as np
import torch

from reference import lowp, nets, search as rsearch

PROGRAM_SECTIONS = ("MODEL", "SEAR", "TEST", "PIXEL_MEANS", "BOX_OFFSET")


class PortSystem:
    """The port, ``kind`` ``'az'`` (proposals) or ``'frcnn'`` (detection)."""

    def __init__(self, conf: dict, kind: str, weights: dict, device):
        from aznet_tpu_torch import api
        from aznet_tpu_torch.config import Config, cfg_from_dict

        self.api = api
        self.cfg = cfg_from_dict(Config(), {k: conf[k] for k in PROGRAM_SECTIONS})
        build = api.build_az_net if kind == "az" else api.build_frcnn_net
        self.net = build(self.cfg, state_dict=weights, device=device)
        self.model = self.net.model  # a traced run logs its ``roi_forward`` calls
        self.trunk, self.head = self.model.trunk, self.model.head

    def propose_batch(self, canvas):
        return self.api.make_propose_batch(self.net.model, self.cfg, tuple(canvas))

    def detect_batch(self, canvas):
        return self.api.make_detect_batch(self.net.model, self.cfg, tuple(canvas))

    def im_propose(self, im: np.ndarray) -> np.ndarray:
        return self.api.im_propose(self.net, im)

    @staticmethod
    def launches() -> dict:
        """The port's own counts of its CUDA kernels' launches: every counter
        of its table (``aznet_tpu_torch.ops.cuda.COUNTERS``), so a kernel a
        later change adds is counted with it."""
        from aznet_tpu_torch.ops.cuda import launch_counts

        return launch_counts()


def reverse_frontier_top_k(cand_buf: int):
    """Plant a fault in the program's search: its frontier's top-k reversed,
    the lowest valid priorities first (the top-k of the ``cand_buf``
    candidate cap untouched). On the card a level runs as one kernel that
    sorts the frontier itself, so the level's plain version, which calls
    ``top_k``, stands in for it while the fault is planted. The check has to
    find it not correct. Returns the function that takes it out again."""
    from aznet_tpu_torch.search import propose

    top_k, level_cuda = propose.top_k, propose.level_cuda

    def reversed_top_k(x, k):
        if k == cand_buf:
            return top_k(x, k)
        _, idx = top_k(torch.where(x > -1e30, -x, x), k)
        return x[idx], idx

    def undo():
        propose.top_k, propose.level_cuda = top_k, level_cuda

    propose.top_k, propose.level_cuda = reversed_top_k, propose.level_plain
    return undo


class ReferenceSystem:
    """The reference in the program's place, each conv and matmul operand
    rounded by ``lowp.ROUNDINGS[rounding]``."""

    def __init__(self, conf: dict, kind: str, weights: dict, device, rounding: str = "fp8"):
        self.conf, self.kind, self.p, self.device = conf, kind, weights, device
        self.q = lowp.ROUNDINGS[rounding]
        self.model = self

    def roi_forward(self, feat, rois):
        return nets.roi_forward(self.conf["MODEL"], self.kind, self.p, feat, rois, self.q)

    def _features(self, images, canvas):
        c, test = self.conf, self.conf["TEST"]
        blobs, scales, extents = [], [], []
        for im in images:
            s = nets.compute_scale(im.shape[0], im.shape[1], test["SCALES"][0], test["MAX_SIZE"])
            blob, vh, vw = nets.preprocess(im, c["PIXEL_MEANS"], s, canvas[0], canvas[1])
            blobs.append(self.q(blob))
            scales.append(torch.tensor(s, dtype=torch.float32, device=self.device))
            extents.append((vh, vw))
        feats = nets.trunk(c["MODEL"], self.p, torch.stack(blobs), self.q)
        return feats, scales, extents

    def _propose(self, images, canvas):
        feats, scales, extents = self._features(images, canvas)
        outs = []
        for i, (s, (vh, vw)) in enumerate(zip(scales, extents)):
            found = rsearch.search(self.roi_forward, nets.image_features(feats, i), vh, vw,
                                   self.conf["SEAR"], self.conf["BOX_OFFSET"])
            outs.append((found.boxes / s, found.scores, found.valid))
        return tuple(torch.stack(t) for t in zip(*outs))

    def propose_batch(self, canvas):
        return lambda images: self._propose(images, canvas)

    def detect_batch(self, canvas):
        off, k = self.conf["BOX_OFFSET"], self.conf["MODEL"]["NUM_CLASSES"]

        def fn(images, boxes):
            feats, scales, _ = self._features(images, canvas)
            h, w = (torch.tensor(float(v), device=self.device) for v in images.shape[1:3])
            outs = []
            for i, (s, b) in enumerate(zip(scales, boxes)):
                out = self.roi_forward(nets.image_features(feats, i), b * s)
                pred = rsearch.decode(b[:, None, :], out["bbox_pred"].reshape(-1, k, 4), off)
                pred = rsearch.clip_to(pred, h, w, off)
                outs.append((torch.softmax(out["cls_score"], -1), pred.reshape(-1, 4 * k)))
            return tuple(torch.stack(t) for t in zip(*outs))
        return fn

    def im_propose(self, im: np.ndarray) -> np.ndarray:
        test = self.conf["TEST"]
        canvas = nets.canvas_for(im.shape[0], im.shape[1], test["SCALES"][0], test["MAX_SIZE"])
        image = torch.from_numpy(np.ascontiguousarray(im)).to(self.device)
        boxes, scores, valid = (t[0] for t in self._propose(image[None], canvas))
        n = int(valid.sum())
        return torch.cat([boxes[:n], scores[:n, None]], 1).float().cpu().numpy()
