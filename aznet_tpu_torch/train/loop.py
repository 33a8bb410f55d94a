"""Training loops (``aznet_tpu/train/loop.py``; the reference's ``train_net``
entry points): minibatches built on the host by a prefetch thread or, with
``TRAIN.NUM_WORKERS >= 2``, by worker processes (``data/prefetch.py``), the
train step on the card, a snapshot every ``SNAPSHOT_ITERS`` steps and at the
end, auto-resume from the latest snapshot, and a ``deploy/`` snapshot with
the bbox normalization baked into the regression layer.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

from aznet_tpu_torch.api import _device
from aznet_tpu_torch.config import Config, get_output_dir
from aznet_tpu_torch.data.imdb import get_imdb
from aznet_tpu_torch.data.minibatch import fixed_canvas, get_az_minibatch, get_frcnn_minibatch
from aznet_tpu_torch.data.prefetch import (MPPrefetcher, az_batch_builder, frcnn_batch_builder,
                                           mirrored_proposals)
from aznet_tpu_torch.train.mining import RegionMiner
from aznet_tpu_torch.train.train_az import make_az_train_state, make_az_train_step
from aznet_tpu_torch.train.train_frcnn import make_frcnn_train_state, make_frcnn_train_step
from aznet_tpu_torch.utils.checkpoint import Checkpointer, bake_bbox_normalization
from aznet_tpu_torch.utils.logging import MetricLogger


def process_local_indices(n_entries: int, pid: int = 0, pcount: int = 1):
    """Process ``pid``'s round-robin share of the roidb (all of it for one
    process; never empty)."""
    idx = list(range(n_entries))[pid::pcount]
    return idx if idx else [0]


def local_batch_size(global_ims: int, pcount: int = 1) -> int:
    """Each of ``pcount`` processes' share of ``IMS_PER_BATCH``; it must
    divide."""
    if global_ims % pcount:
        raise ValueError(f"TRAIN.IMS_PER_BATCH={global_ims} must be divisible by the process "
                         f"count ({pcount}); the global batch is assembled from equal shares")
    return global_ims // pcount


class _Prefetcher:
    """One host thread building minibatches ahead (the reference's
    BlobFetcher), from the stateful ``make_batch()``."""

    def __init__(self, make_batch, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error = None

        def worker():
            pending = None
            try:
                while not self._stop.is_set():
                    # Build each batch once and retry the put: rebuilding on a
                    # full queue would make the seeded stream timing-dependent.
                    if pending is None:
                        pending = make_batch()
                    try:
                        self._q.put(pending, timeout=0.5)
                        pending = None
                    except queue.Full:
                        continue
            except Exception as e:  # noqa: BLE001 - raised again by next()
                self._error = e
                self._q.put(None)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next(self):
        batch = self._q.get()
        if batch is None:
            raise RuntimeError("the prefetch thread failed") from self._error
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def _run_loop(state, step_fn, make_prefetcher, cfg: Config, max_iters: int, output_dir: str,
              name: str, resume: bool = True, interval_hook=None):
    """Steps ``state.step .. max_iters``. With ``resume`` the latest snapshot
    in ``output_dir`` (parameters, optimizer state, step) is restored first;
    ``make_prefetcher(start_step)`` then builds the batch source.
    ``interval_hook``: ``(interval, fn(step, state))``, called on the main
    thread before every step that is a multiple of ``interval``."""
    logger = MetricLogger(output_dir, name)
    ckpt = Checkpointer(output_dir, prefix=cfg.TRAIN.SNAPSHOT_PREFIX)
    start_step = 0
    if resume and ckpt.latest_step() is not None:
        restored, start_step = ckpt.restore({"params": 0, "opt_state": 0, "step": 0})
        state.restore(restored)
        print(f"[{name}] resumed from step {start_step}")
    prefetcher = make_prefetcher(start_step)
    try:
        for it in range(start_step, max_iters):
            if interval_hook is not None and interval_hook[0] > 0 and it % interval_hook[0] == 0:
                interval_hook[1](it, state)
            metrics = step_fn(state, prefetcher.next(), cfg.RNG_SEED)
            if (it + 1) % 20 == 0 or it + 1 == max_iters:
                logger.log(it + 1, {k: float(v) for k, v in metrics.items()}, prefix=f"{name} ")
            if (it + 1) % cfg.TRAIN.SNAPSHOT_ITERS == 0 or it + 1 == max_iters:
                ckpt.save(it + 1, state.snapshot())
    finally:
        prefetcher.close()
    return state


def _deploy(state, cfg: Config, output_dir: str, max_iters: int, head_name: str) -> None:
    """The ``deploy/`` snapshot: parameters with the normalization baked in."""
    if cfg.TRAIN.BBOX_NORMALIZE_TARGETS:
        baked = bake_bbox_normalization(state.model.state_dict(), cfg.TRAIN.BBOX_NORMALIZE_MEANS,
                                        cfg.TRAIN.BBOX_NORMALIZE_STDS, head_name=head_name)
        Checkpointer(output_dir + "/deploy").save(max_iters, {"params": baked})


def train_az_net(cfg: Config, imdb_name: str, max_iters: Optional[int] = None,
                 output_dir: Optional[str] = None, state=None, imdb=None, device="cuda"):
    """Train AZ-Net on an imdb, on the card unless ``device='cpu'``. Returns
    ``(state, model, output_dir)``. Hard-region mining
    (``TRAIN.MINE_INTERVAL``) needs the prefetch thread, which shares the
    miner's cache."""
    device = _device(device)
    imdb = imdb or get_imdb(imdb_name)
    if cfg.TRAIN.USE_FLIPPED:
        imdb.append_flipped_images()
    canvas = fixed_canvas(imdb, cfg)
    if state is None:
        state = make_az_train_state(cfg, device=device)
    output_dir = output_dir or get_output_dir(cfg, imdb.name, "aznet")
    max_iters = max_iters or cfg.TRAIN.MAX_ITERS
    pid, pcount = 0, 1
    seed = cfg.RNG_SEED + 1000003 * pid
    rng = np.random.RandomState(seed)
    roidb = imdb.roidb
    local_idx = process_local_indices(len(roidb), pid, pcount)
    ims_local = local_batch_size(cfg.TRAIN.IMS_PER_BATCH, pcount)

    miner = hook = None
    if cfg.TRAIN.MINE_INTERVAL > 0:
        miner = RegionMiner(cfg, imdb, local_idx)

        def _mine(step, st):
            n = miner.harvest(st.model)
            print(f"[az] mined search regions for {n} images at step {step}")

        hook = (cfg.TRAIN.MINE_INTERVAL, _mine)

    def make_batch():
        idx = rng.choice(local_idx, size=ims_local)
        mined = [miner.mined_for(i) for i in idx] if miner is not None else None
        return get_az_minibatch(imdb, [roidb[i] for i in idx], cfg, rng, canvas,
                                mined_by_entry=mined)

    def make_prefetcher(start):
        if cfg.TRAIN.NUM_WORKERS > 1:
            if miner is not None:
                print("[az] TRAIN.NUM_WORKERS ignored: hard-region mining needs the "
                      "in-process prefetch thread")
            else:
                return MPPrefetcher(az_batch_builder, {
                    "imdb_name": imdb_name, "cfg": cfg, "seed": seed, "pid": pid,
                    "pcount": pcount, "ims_local": ims_local},
                    workers=cfg.TRAIN.NUM_WORKERS, start=start)
        return _Prefetcher(make_batch)

    step_fn = make_az_train_step(state.model, (cfg.TRAIN.ZOOM_POS_WEIGHT,
                                               cfg.TRAIN.ADJ_POS_WEIGHT),
                                 remat_trunk=cfg.TRAIN.REMAT_TRUNK)
    state = _run_loop(state, step_fn, make_prefetcher, cfg, max_iters, output_dir, "az",
                      interval_hook=hook)
    _deploy(state, cfg, output_dir, max_iters, "adj_bbox")
    return state, state.model, output_dir


def train_frcnn_net(cfg: Config, imdb_name: str, proposals_fn, max_iters: Optional[int] = None,
                    output_dir: Optional[str] = None, state=None, imdb=None,
                    proposals_path: Optional[str] = None, device="cuda"):
    """Train Fast R-CNN on an imdb with proposals, on the card unless
    ``device='cpu'``. ``proposals_fn(entry_index) -> [N, 4+]`` boxes in
    original coordinates (the chained flow: AZ-Net's proposals).
    ``proposals_path``, the pickle behind ``proposals_fn``, is what
    ``TRAIN.NUM_WORKERS >= 2`` needs: a callable cannot cross to a worker."""
    device = _device(device)
    imdb = imdb or get_imdb(imdb_name)
    if cfg.TRAIN.USE_FLIPPED:
        imdb.append_flipped_images()
    canvas = fixed_canvas(imdb, cfg)
    if state is None:
        state = make_frcnn_train_state(cfg, device=device)
    output_dir = output_dir or get_output_dir(cfg, imdb.name, "frcnn")
    max_iters = max_iters or cfg.TRAIN.MAX_ITERS
    pid, pcount = 0, 1
    seed = cfg.RNG_SEED + 1000003 * pid
    rng = np.random.RandomState(seed)
    roidb = imdb.roidb
    local_idx = process_local_indices(len(roidb), pid, pcount)
    ims_local = local_batch_size(cfg.TRAIN.IMS_PER_BATCH, pcount)

    def make_batch():
        idx = rng.choice(local_idx, size=ims_local)
        entries = [roidb[i] for i in idx]
        props = [mirrored_proposals(proposals_fn(int(i)), e) for i, e in zip(idx, entries)]
        return get_frcnn_minibatch(imdb, entries, props, cfg, rng, canvas)

    def make_prefetcher(start):
        if cfg.TRAIN.NUM_WORKERS > 1:
            if proposals_path is None:
                print("[frcnn] TRAIN.NUM_WORKERS ignored: workers need proposals_path "
                      "(a pickle), not a bare proposals_fn")
            else:
                return MPPrefetcher(frcnn_batch_builder, {
                    "imdb_name": imdb_name, "cfg": cfg, "seed": seed, "pid": pid,
                    "pcount": pcount, "ims_local": ims_local, "proposals_path": proposals_path},
                    workers=cfg.TRAIN.NUM_WORKERS, start=start)
        return _Prefetcher(make_batch)

    state = _run_loop(state, make_frcnn_train_step(state.model), make_prefetcher, cfg,
                      max_iters, output_dir, "frcnn")
    _deploy(state, cfg, output_dir, max_iters, "bbox_pred")
    return state, state.model, output_dir
