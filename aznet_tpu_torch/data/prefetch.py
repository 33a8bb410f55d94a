"""Multi-process minibatch prefetcher, ``TRAIN.NUM_WORKERS >= 2``
(``aznet_tpu/data/prefetch.py``).

- **Workers never touch the card.** They are ``spawn``ed (a fork would copy
  the parent's CUDA state) with ``CUDA_VISIBLE_DEVICES`` empty from the
  start, so the card is hidden before the child imports torch; each worker
  checks after every batch that CUDA is still uninitialised and reports
  whether ``jax`` or CUDA came up, and how long its latest batch took to
  build (:attr:`MPPrefetcher.worker_env`). Batch building is NumPy and the
  host library.
- **The batch stream is deterministic and worker-count invariant.** Batch
  ``t`` is built with ``rng_for_batch(seed, t)``; worker ``w`` of ``W`` builds
  ``t = start + w, start + w + W, ...`` and the consumer puts them back in
  order. A run resumed at step ``s`` starts at ``start = s`` and so draws
  the batches an uninterrupted run would.
- **Specs are picklable.** A worker rebuilds its world from a module-level
  builder and a plain dict: the imdb by registry name, proposals from their
  pickle path. A custom in-memory imdb or the region miner (whose cache the
  main process updates) needs the in-process thread of ``train/loop.py``.
- A worker that raises sends its traceback, and :meth:`MPPrefetcher.next`
  raises it in the parent; it raises too when a worker has exited without
  a word (one that could not even start), instead of waiting forever.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import sys
import time
import traceback
from typing import Callable

import numpy as np

__all__ = ["MPPrefetcher", "rng_for_batch", "az_batch_builder", "frcnn_batch_builder"]


def rng_for_batch(seed: int, t: int) -> np.random.RandomState:
    """Per-batch-index RandomState, the same for any worker count."""
    ss = np.random.SeedSequence([int(seed) & 0x7FFFFFFF, int(t)])
    return np.random.RandomState(ss.generate_state(4))


def _shard_indices(n_entries: int, pid: int, pcount: int):
    """This process's round-robin share of the roidb (never empty)."""
    idx = list(range(n_entries))[pid::pcount]
    return idx if idx else [0]


def _world(args: dict):
    from aznet_tpu_torch.data.imdb import get_imdb
    from aznet_tpu_torch.data.minibatch import fixed_canvas

    cfg = args["cfg"]
    imdb = get_imdb(args["imdb_name"])
    if cfg.TRAIN.USE_FLIPPED:
        imdb.append_flipped_images()
    return cfg, imdb, fixed_canvas(imdb, cfg), _shard_indices(len(imdb.roidb), args["pid"],
                                                               args["pcount"])


def az_batch_builder(args: dict) -> Callable[[int], dict]:
    """``make_batch(t)`` for AZ minibatches: ``args`` holds ``imdb_name``,
    ``cfg``, ``seed``, ``pid``, ``pcount``, ``ims_local``."""
    from aznet_tpu_torch.data.minibatch import get_az_minibatch

    cfg, imdb, canvas, local_idx = _world(args)
    roidb = imdb.roidb

    def make_batch(t: int) -> dict:
        rng = rng_for_batch(args["seed"], t)
        idx = rng.choice(local_idx, size=args["ims_local"])
        return get_az_minibatch(imdb, [roidb[i] for i in idx], cfg, rng, canvas)

    return make_batch


def frcnn_batch_builder(args: dict) -> Callable[[int], dict]:
    """``make_batch(t)`` for Fast R-CNN minibatches, with the proposals read
    from ``args["proposals_path"]`` (a pickled list, one ``[N, 4+]`` array per
    image); a flipped entry's proposals are mirrored."""
    from aznet_tpu_torch.data.minibatch import get_frcnn_minibatch

    cfg, imdb, canvas, local_idx = _world(args)
    roidb = imdb.roidb
    with open(args["proposals_path"], "rb") as f:
        props_all = pickle.load(f)

    def make_batch(t: int) -> dict:
        rng = rng_for_batch(args["seed"], t)
        idx = rng.choice(local_idx, size=args["ims_local"])
        entries = [roidb[i] for i in idx]
        props = [mirrored_proposals(props_all[int(i) % len(props_all)], e)
                 for i, e in zip(idx, entries)]
        return get_frcnn_minibatch(imdb, entries, props, cfg, rng, canvas)

    return make_batch


def mirrored_proposals(props, entry) -> np.ndarray:
    """``[N, 4]`` float copy of an image's cached proposals, mirrored (``x1' =
    W - x2 - 1``) when ``entry`` is a flipped roidb entry: proposals come
    from the unflipped image."""
    p = np.asarray(props)[:, :4].copy()
    if entry.get("flipped"):
        p[:, [0, 2]] = entry["width"] - p[:, [2, 0]] - 1.0
    return p


def _worker_env() -> dict:
    torch = sys.modules.get("torch")
    return {"jax_imported": "jax" in sys.modules,
            "cuda_initialized": bool(torch is not None and torch.cuda.is_initialized()),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}


def _put(q, item, stop) -> bool:
    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            continue
    return False


def _worker_main(builder, builder_args, w: int, n_workers: int, start: int, q, stop):
    try:
        make_batch = builder(builder_args)
        t = start + w
        while not stop.is_set():
            t0 = time.perf_counter()
            batch = make_batch(t)
            env = dict(_worker_env(), batch_s=time.perf_counter() - t0)
            if env["cuda_initialized"]:
                raise RuntimeError("a prefetch worker initialised CUDA")
            if not _put(q, ("batch", t, batch, (w, env)), stop):
                return
            t += n_workers
    except Exception:  # noqa: BLE001 - reported to the parent, which raises it
        _put(q, ("error", w, traceback.format_exc(), None), stop)


class MPPrefetcher:
    """``workers`` spawned processes with ``next()`` / ``close()``, as the
    loop's prefetch thread. ``builder(builder_args) -> make_batch(t)`` must be
    picklable (a module-level function and a plain dict). Batches come back
    in the order ``t = start, start + 1, ...``."""

    def __init__(self, builder, builder_args: dict, workers: int, depth: int = 4,
                 start: int = 0):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        ctx = mp.get_context("spawn")
        self._stop = ctx.Event()
        self._q = ctx.Queue(maxsize=max(depth, workers))
        self._procs = [ctx.Process(target=_worker_main,
                                   args=(builder, builder_args, w, workers, start, self._q,
                                         self._stop),
                                   daemon=True)
                       for w in range(workers)]
        # The children inherit the environment at start: hide the card there.
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            for p in self._procs:
                p.start()
        finally:
            if saved is None:
                del os.environ["CUDA_VISIBLE_DEVICES"]
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved
        self._buf: dict = {}
        self._t = start
        self.worker_env: dict = {}  # worker -> _worker_env() after its latest batch

    def next(self):
        while self._t not in self._buf:
            try:
                kind, key, payload, info = self._q.get(timeout=1.0)
            except queue.Empty:
                dead = [(w, p.exitcode) for w, p in enumerate(self._procs) if not p.is_alive()]
                if dead:  # exited without a batch or a traceback (e.g. failed to start)
                    raise RuntimeError(f"prefetch workers exited: {dead} (worker, exit code)")
                continue
            if kind == "error":
                raise RuntimeError(f"prefetch worker {key} failed:\n{payload}")
            self._buf[key] = payload
            self.worker_env[info[0]] = info[1]
        out = self._buf.pop(self._t)
        self._t += 1
        return out

    def close(self):
        self._stop.set()
        # Drain so that workers blocked on put() see the stop event.
        try:
            while True:
                self._q.get(timeout=0.2)
        except queue.Empty:
            pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self._q.close()
        self._q.join_thread()
