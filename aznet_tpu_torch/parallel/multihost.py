"""A small launcher of ranks, and the multi-host dry run
(``aznet_tpu/parallel/multihost.py``).

:func:`launch` starts ``world`` rank processes, each ``python -m
aznet_tpu_torch.parallel.multihost``, spread over ``hosts`` simulated hosts
with ``torchrun``'s variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``GROUP_RANK``). Each rank joins the process group
through a ``FileStore`` in a new temporary directory (no TCP port, so that
launches in parallel never race for one), sets one thread, and calls
``target(*args)``. The group's timeout is at most 120 s, so that a hung
collective fails; a rank that fails ends the launch at once.

:func:`run_multihost_dryrun` is the reference's check of the multi-host
input path: each host samples its roidb shard, builds its local AZ batch,
keeps its rows of the global batch and runs one train step on a
``('data', 'model'=2)`` mesh; rank 0 reports the line

    dryrun_multihost: processes=2 devices=4 mesh={'data': 2, 'model': 2} global_batch=4 loss=... OK

Usage: ``run_multihost_dryrun(num_processes=2, devices_per_proc=2)``.
"""

from __future__ import annotations

import datetime
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

from aznet_tpu_torch.parallel.mesh import GROUP_TIMEOUT_S

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STORE_ENV = "AZNET_DIST_STORE"  # the ranks' rendezvous file


def _resolve(target: str):
    """``"package.module:function"`` or ``"path/to/file.py:function"``."""
    mod_name, fn_name = target.rsplit(":", 1)
    if mod_name.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            os.path.splitext(os.path.basename(mod_name))[0], mod_name)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(mod_name)
    return getattr(mod, fn_name)


def launch(world: int, target: str, args=(), backend: str = "gloo", hosts: int = 1,
           timeout: float = 300.0) -> list:
    """Runs ``target(*args)`` (``args`` JSON-able) in ``world`` rank
    processes over ``hosts`` hosts of ``world // hosts`` ranks each, and
    returns each rank's standard output. Raises, after ending every rank,
    when a rank fails or the launch outlasts ``timeout`` seconds."""
    if world % hosts:
        raise ValueError(f"{world} ranks do not split over {hosts} hosts")
    local = world // hosts
    with tempfile.TemporaryDirectory(prefix="aznet_launch_") as tmp:
        env = dict(os.environ, WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(local),
                   **{STORE_ENV: os.path.join(tmp, "store")})
        env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
        procs, logs = [], []
        for rank in range(world):
            out = open(os.path.join(tmp, f"rank{rank}.out"), "w+")
            err = open(os.path.join(tmp, f"rank{rank}.err"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "aznet_tpu_torch.parallel.multihost", target,
                 json.dumps(list(args)), backend],
                cwd=REPO, stdout=out, stderr=err,
                env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank % local),
                         GROUP_RANK=str(rank // local))))
        try:
            _wait(procs, logs, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            texts = []
            for out, err in logs:
                out.seek(0)
                texts.append(out.read())
                out.close()
                err.close()
        return texts


def _tail(f, n=3000) -> str:
    f.seek(0)
    return f.read()[-n:]


def _wait(procs, logs, timeout) -> None:
    t_end = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        for rank, rc in enumerate(codes):
            if rc not in (None, 0):
                raise RuntimeError(f"rank {rank} exited with {rc}:\n{_tail(logs[rank][1])}")
        if all(rc == 0 for rc in codes):
            return
        if time.monotonic() > t_end:
            raise RuntimeError(f"ranks {[r for r, rc in enumerate(codes) if rc is None]} still "
                               f"running after {timeout} s")
        time.sleep(0.05)


def _rank_main(target: str, args: list, backend: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    world = int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        backend, store=dist.FileStore(os.environ[STORE_ENV], world),
        rank=int(os.environ["RANK"]), world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        _resolve(target)(*args)
    finally:
        dist.destroy_process_group()


def run_multihost_dryrun(num_processes: int = 2, devices_per_proc: int = 2,
                         timeout: float = 300.0) -> str:
    """Launch the dry run on the CPU (gloo); return rank 0's report line."""
    if devices_per_proc < 2:
        # The mesh is (data, model=2): each host needs at least one model group.
        raise ValueError(f"devices_per_proc must be >= 2 (got {devices_per_proc}): the mesh "
                         "is (data, model=2)")
    outs = launch(num_processes * devices_per_proc, "aznet_tpu_torch.parallel.multihost:_dryrun",
                  (num_processes,), hosts=num_processes, timeout=timeout)
    report = [line for line in outs[0].splitlines() if line.startswith("dryrun_multihost")]
    if not report:
        raise RuntimeError(f"multihost dryrun: no report line:\n{outs[0][-1000:]}")
    print(report[-1])
    return report[-1]


def _dryrun(num_processes: int) -> None:
    """One rank of the dry run (smallnet, float32, on the CPU)."""
    import numpy as np
    import torch.distributed as dist

    from aznet_tpu_torch.config import Config, cfg_from_dict
    from aznet_tpu_torch.data.minibatch import get_az_minibatch
    from aznet_tpu_torch.data.synthetic import SyntheticImdb
    from aznet_tpu_torch.parallel.mesh import host_count, host_index, make_mesh
    from aznet_tpu_torch.train.loop import (local_batch_size, make_global_batch,
                                            process_local_indices)
    from aznet_tpu_torch.train.train_az import make_az_train_state, make_az_train_step

    pid, pcount = host_index(), host_count()
    assert pcount == num_processes, pcount
    cfg = cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 32, "NUM_TEMPLATES": 5,
                  "NUM_CLASSES": 4, "COMPUTE_DTYPE": "float32"},
        "TRAIN": {"SCALES": (64,), "MAX_SIZE": 96, "REGIONS_PER_IMAGE": 8,
                  "IMS_PER_BATCH": 2 * num_processes, "USE_FLIPPED": False},
    })
    imdb = SyntheticImdb(num_images=8)
    # The multi-host input path: this host's roidb shard, its local batch,
    # this rank's rows of the global batch.
    shard = process_local_indices(len(imdb.roidb), pid, pcount)
    assert len(shard) == len(imdb.roidb) // pcount
    ims_local = local_batch_size(cfg.TRAIN.IMS_PER_BATCH, pcount)
    rng = np.random.RandomState(100 + pid)
    entries = [imdb.roidb[shard[i % len(shard)]] for i in range(ims_local)]
    batch = get_az_minibatch(imdb, entries, cfg, rng, canvas=(64, 96))

    world = dist.get_world_size()
    mesh = make_mesh(world, model_parallel=2, device="cpu")
    state = make_az_train_state(cfg, device="cpu", mesh=mesh)
    rows = make_global_batch(batch, mesh)
    global_batch = len(rows["images"]) * mesh.shape["data"]
    assert global_batch == cfg.TRAIN.IMS_PER_BATCH, global_batch
    loss = float(make_az_train_step(state.model, mesh=mesh)(state, rows, 1)["loss"])
    assert np.isfinite(loss), loss
    if dist.get_rank() == 0:
        print(f"dryrun_multihost: processes={pcount} devices={world} mesh={mesh.shape} "
              f"global_batch={global_batch} loss={loss:.4f} OK", flush=True)


if __name__ == "__main__":
    _rank_main(sys.argv[1], json.loads(sys.argv[2]), sys.argv[3])
