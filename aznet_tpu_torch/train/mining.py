"""Search-driven hard-region mining for AZ training
(``aznet_tpu/train/mining.py``).

Every ``TRAIN.MINE_INTERVAL`` steps the training loop runs the real zoom
search (``az_search(collect_frontier=True)``, through the NMS kernel on the
card) with the CURRENT weights over the next ``TRAIN.MINE_IMAGES`` training
images and caches the frontier regions it visited; the minibatch sampler
mixes them into the anchor pool, so that training sees the regions the
search visits. The search runs on an inference copy of the weights, cast as
the API casts an inference net (bf16 in bf16 mode: the fused head dot sees
bf16-rounded head weights, as the reference's ``_cast_inference_params``
makes it), under ``torch.no_grad()``. The cache is NumPy on the host, so the
prefetch thread never touches the card.

Under a mesh each host harvests its own roidb shard. The inference copy is
made from the whole weights, fc6/fc7 gathered over ``model`` once a harvest
(a collective every rank calls at the same step); each rank then searches
its host's images alone, with no collective in the search.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from aznet_tpu_torch.config import Config
from aznet_tpu_torch.data.minibatch import fixed_canvas
from aznet_tpu_torch.ops.preprocess import compute_scale, preprocess_image
from aznet_tpu_torch.search.propose import az_search


def make_harvest_fn(model, cfg: Config, canvas_hw):
    """``fn(images [B, Hp, Wp, 3] raw, src_hw [B, 2], scales [B]) -> (visited
    [B, V, 4] in original coordinates, visited_valid [B, V])`` for an
    inference net ``model``: each image onto the training canvas at
    ``TRAIN.SCALES[0]``, one trunk call, the search per image."""
    from aznet_tpu_torch.api import _blob_dtype

    @torch.no_grad()
    def fn(images, src_hw, scales):
        preps = [preprocess_image(images[i], cfg.PIXEL_MEANS, cfg.TRAIN.SCALES[0],
                                  cfg.TRAIN.MAX_SIZE, canvas_hw[0], canvas_hw[1],
                                  dtype=_blob_dtype(cfg), src_hw=src_hw[i], scale=scales[i])
                 for i in range(images.shape[0])]
        feats = model.features(torch.stack([p[0] for p in preps]))
        vis, ok = [], []
        for feat, (_, im_scale, valid_hw) in zip(feats, preps):
            *_, v, v_ok = az_search(model.roi_forward, feat, valid_hw, cfg.SEAR,
                                    num_templates=cfg.MODEL.NUM_TEMPLATES,
                                    offset=cfg.BOX_OFFSET, collect_frontier=True)
            vis.append(v / im_scale)
            ok.append(v_ok)
        return torch.stack(vis), torch.stack(ok)

    return fn


class RegionMiner:
    """Rotating harvest of search-visited regions over ``local_indices``.

    ``harvest(model)`` searches the next ``TRAIN.MINE_IMAGES`` images (in
    batches of ``batch_size``) and sets ``cache[idx]`` to their ``[M, 4]``
    float32 regions in original coordinates, the level-0 block (the seeds,
    which the static tree covers) and the padding dropped, at most the last
    ``max_regions`` (the deepest levels)."""

    def __init__(self, cfg: Config, imdb, local_indices: List[int], batch_size: int = 8,
                 max_regions: int = 96, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.imdb = imdb
        self.indices = list(local_indices)
        self.batch_size = batch_size
        self.max_regions = max_regions
        self.cache: Dict[int, np.ndarray] = {}
        self._cursor = 0
        rup = lambda v, m=32: int(-(-v // m) * m)  # noqa: E731
        roidb = imdb.roidb
        self._raw_hw = (rup(max(roidb[i]["height"] for i in self.indices)),
                        rup(max(roidb[i]["width"] for i in self.indices)))
        self._canvas = fixed_canvas(imdb, cfg)

    def _next_chunk(self):
        n = min(self.cfg.TRAIN.MINE_IMAGES, len(self.indices))
        out = [self.indices[(self._cursor + j) % len(self.indices)] for j in range(n)]
        self._cursor = (self._cursor + n) % len(self.indices)
        return out

    def harvest(self, model) -> int:
        """One mining pass with the weights of ``model`` (a training net,
        split over the miner's mesh if it has one); returns the number of
        images refreshed."""
        from aznet_tpu_torch.api import inference_model, new_model
        from aznet_tpu_torch.parallel.mesh import gather_rows, param_sharding

        cfg, tcfg = self.cfg, self.cfg.TRAIN
        dev = next(model.parameters()).device
        sd = model.state_dict()
        if self.mesh is not None:
            sd = gather_rows(sd, self.mesh, param_sharding(self.mesh, sd))
        net = inference_model(new_model(type(model), cfg, dev, sd), cfg)
        fn = make_harvest_fn(net, cfg, self._canvas)
        roidb = self.imdb.roidb
        chunk = self._next_chunk()
        hp, wp = self._raw_hw
        r_cap = cfg.SEAR.FRONTIER_CAP
        for start in range(0, len(chunk), self.batch_size):
            sub = chunk[start:start + self.batch_size]
            ims = np.zeros((len(sub), hp, wp, 3), np.float32)
            src_hw = np.ones((len(sub), 2), np.float32)
            scales = np.ones((len(sub),), np.float32)
            for j, i in enumerate(sub):
                im = self.imdb.image_array(roidb[i])
                ims[j, :im.shape[0], :im.shape[1]] = im
                src_hw[j] = im.shape[:2]
                scales[j] = compute_scale(im.shape[0], im.shape[1], tcfg.SCALES[0], tcfg.MAX_SIZE)
            vis, ok = fn(*(torch.from_numpy(a).to(dev) for a in (ims, src_hw, scales)))
            vis, ok = vis.cpu().numpy(), ok.cpu().numpy()
            for j, i in enumerate(sub):
                v = vis[j][r_cap:][ok[j][r_cap:]]
                self.cache[i] = np.asarray(v[-self.max_regions:], np.float32)
        return len(chunk)

    def mined_for(self, idx: int):
        return self.cache.get(idx)
