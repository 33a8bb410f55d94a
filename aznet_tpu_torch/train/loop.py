"""Training loops (``aznet_tpu/train/loop.py``; the reference's ``train_net``
entry points): minibatches built on the host by a prefetch thread or, with
``TRAIN.NUM_WORKERS >= 2``, by worker processes (``data/prefetch.py``), the
train step on the card, a snapshot every ``SNAPSHOT_ITERS`` steps and at the
end, auto-resume from the latest snapshot, and a ``deploy/`` snapshot with
the bbox normalization baked into the regression layer.

With ``mesh=`` (``parallel/mesh.py``) the loops run data + tensor parallel:
each host samples its own roidb shard from its own seed (the host index and
count are ``torchrun``'s), every rank of a host builds the same host batch
and keeps its rows of the global batch (:func:`make_global_batch`), global
rank 0 alone logs and writes snapshots (gathered into the single-process
layout) while the other ranks wait, and every rank restores the same
snapshot and keeps its part.
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
from aznet_tpu_torch.parallel.mesh import barrier, host_count, host_index
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


def make_global_batch(batch: dict, mesh) -> dict:
    """This rank's rows of the global batch. The global batch is the hosts'
    local batches (``batch``, the same on every rank of a host) concatenated
    in host order, as the reference's ``make_array_from_process_local_data``
    assembles it; its leading dim splits over ``data``, so every rank of a
    ``model`` group holds the same rows. No collective: a rank's rows must
    lie in its own host's batch, which holds when ``model`` groups do not
    span hosts."""
    rows = len(next(iter(batch.values())))
    pid, total = host_index(), rows * host_count()
    data = mesh.shape["data"]
    if total % data:
        raise ValueError(f"the global batch of {total} images does not split over data={data}")
    per = total // data
    start = mesh.coords["data"] * per - pid * rows
    if start < 0 or start + per > rows:
        raise ValueError(f"rows {start + pid * rows}..{start + pid * rows + per} of the global "
                         f"batch are not on host {pid}: a model group spans hosts")
    return {k: v[start:start + per] for k, v in batch.items()}


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


class _Inline:
    """Builds each batch when it is asked for, on the calling thread. Under
    a mesh with mining: every rank of a host must build the same batch,
    which a thread racing the harvests' cache updates would not."""

    def __init__(self, make_batch):
        self.next = make_batch

    def close(self):
        pass


def _lead(mesh) -> bool:
    """Whether this rank logs and writes (global rank 0, or no mesh)."""
    return mesh is None or mesh.rank(("data", "model")) == 0


def _save(ckpt: Checkpointer, step: int, tree_fn, mesh) -> None:
    """``tree_fn()`` (a collective under a mesh: every rank calls it) written
    by the lead rank while the others wait."""
    tree = tree_fn()
    if _lead(mesh):
        ckpt.save(step, tree)
    if mesh is not None:
        barrier(mesh)


def _run_loop(state, step_fn, make_prefetcher, cfg: Config, max_iters: int, output_dir: str,
              name: str, resume: bool = True, interval_hook=None, mesh=None):
    """Steps ``state.step .. max_iters``. With ``resume`` the latest snapshot
    in ``output_dir`` (parameters, optimizer state, step) is restored first;
    ``make_prefetcher(start_step)`` then builds the batch source.
    ``interval_hook``: ``(interval, fn(step, state))``, called on the main
    thread before every step that is a multiple of ``interval``. Under
    ``mesh`` each host batch is cut to this rank's rows."""
    logger = MetricLogger(output_dir if _lead(mesh) else None, name)
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
            batch = prefetcher.next()
            if mesh is not None:
                batch = make_global_batch(batch, mesh)
            metrics = step_fn(state, batch, cfg.RNG_SEED)
            if _lead(mesh) and ((it + 1) % 20 == 0 or it + 1 == max_iters):
                logger.log(it + 1, {k: float(v) for k, v in metrics.items()}, prefix=f"{name} ")
            if (it + 1) % cfg.TRAIN.SNAPSHOT_ITERS == 0 or it + 1 == max_iters:
                _save(ckpt, it + 1, state.snapshot, mesh)
    finally:
        prefetcher.close()
    return state


def _deploy(state, cfg: Config, output_dir: str, max_iters: int, head_name: str,
            mesh=None) -> None:
    """The ``deploy/`` snapshot: parameters with the normalization baked in."""
    if cfg.TRAIN.BBOX_NORMALIZE_TARGETS:
        def baked():
            return {"params": bake_bbox_normalization(
                state.full_state_dict(), cfg.TRAIN.BBOX_NORMALIZE_MEANS,
                cfg.TRAIN.BBOX_NORMALIZE_STDS, head_name=head_name)}

        _save(Checkpointer(output_dir + "/deploy"), max_iters, baked, mesh)


def _start(cfg: Config, device, mesh, state, make_state):
    """The state of a loop (a new one on ``device``, or the mesh's device,
    unless given), and its host index and count (0 and 1 without a process
    group)."""
    if mesh is None:
        _device(device)  # the card unless device='cpu': raises without one
    if state is None:
        state = make_state(cfg, device=device, mesh=mesh)
    elif state.mesh is not mesh:
        raise ValueError("the given train state was made for another mesh")
    return state, host_index(), host_count()


def train_az_net(cfg: Config, imdb_name: str, max_iters: Optional[int] = None,
                 output_dir: Optional[str] = None, state=None, imdb=None, device="cuda",
                 mesh=None):
    """Train AZ-Net on an imdb, on the card unless ``device='cpu'``. Returns
    ``(state, model, output_dir)``. Hard-region mining
    (``TRAIN.MINE_INTERVAL``) needs the prefetch thread, which shares the
    miner's cache; under a mesh the batches are then built on the main
    thread (:class:`_Inline`). ``mesh``: data + tensor parallel over its
    ranks (a given ``state`` must have been made for it)."""
    state, pid, pcount = _start(cfg, device, mesh, state, make_az_train_state)
    imdb = imdb or get_imdb(imdb_name)
    if cfg.TRAIN.USE_FLIPPED:
        imdb.append_flipped_images()
    canvas = fixed_canvas(imdb, cfg)
    output_dir = output_dir or get_output_dir(cfg, imdb.name, "aznet")
    max_iters = max_iters or cfg.TRAIN.MAX_ITERS
    seed = cfg.RNG_SEED + 1000003 * pid
    rng = np.random.RandomState(seed)
    roidb = imdb.roidb
    local_idx = process_local_indices(len(roidb), pid, pcount)
    ims_local = local_batch_size(cfg.TRAIN.IMS_PER_BATCH, pcount)

    miner = hook = None
    if cfg.TRAIN.MINE_INTERVAL > 0:
        miner = RegionMiner(cfg, imdb, local_idx, mesh=mesh)

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
        if miner is not None and mesh is not None:
            return _Inline(make_batch)
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
                                 remat_trunk=cfg.TRAIN.REMAT_TRUNK, mesh=mesh)
    state = _run_loop(state, step_fn, make_prefetcher, cfg, max_iters, output_dir, "az",
                      interval_hook=hook, mesh=mesh)
    _deploy(state, cfg, output_dir, max_iters, "adj_bbox", mesh)
    return state, state.model, output_dir


def train_frcnn_net(cfg: Config, imdb_name: str, proposals_fn, max_iters: Optional[int] = None,
                    output_dir: Optional[str] = None, state=None, imdb=None,
                    proposals_path: Optional[str] = None, device="cuda", mesh=None):
    """Train Fast R-CNN on an imdb with proposals, on the card unless
    ``device='cpu'``. ``proposals_fn(entry_index) -> [N, 4+]`` boxes in
    original coordinates (the chained flow: AZ-Net's proposals).
    ``proposals_path``, the pickle behind ``proposals_fn``, is what
    ``TRAIN.NUM_WORKERS >= 2`` needs: a callable cannot cross to a worker.
    ``mesh`` as in :func:`train_az_net`."""
    state, pid, pcount = _start(cfg, device, mesh, state, make_frcnn_train_state)
    imdb = imdb or get_imdb(imdb_name)
    if cfg.TRAIN.USE_FLIPPED:
        imdb.append_flipped_images()
    canvas = fixed_canvas(imdb, cfg)
    output_dir = output_dir or get_output_dir(cfg, imdb.name, "frcnn")
    max_iters = max_iters or cfg.TRAIN.MAX_ITERS
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

    state = _run_loop(state, make_frcnn_train_step(state.model, mesh=mesh), make_prefetcher, cfg,
                      max_iters, output_dir, "frcnn", mesh=mesh)
    _deploy(state, cfg, output_dir, max_iters, "bbox_pred", mesh)
    return state, state.model, output_dir
