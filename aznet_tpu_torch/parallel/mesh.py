"""The ``('data', 'model')`` mesh and its sharding rules
(``aznet_tpu/parallel/mesh.py``) over ``torch.distributed``.

One process is one rank and holds one device, as under ``torchrun``. The
reference's logical mesh of devices is a ``DeviceMesh`` over the ranks,
``(n // model_parallel, model_parallel)`` with the dims named ``data`` and
``model``: rank ``r`` sits at ``(r // model_parallel, r % model_parallel)``.
Data parallelism splits the batch over ``data``; tensor parallelism splits
fc6/fc7's output features over ``model``; everything else is replicated.

Where the reference lets XLA insert the collectives, the port calls them
itself, through :func:`all_gather` and :func:`all_reduce`, which count their
calls in :data:`COLLECTIVES` (NCCL on the card, gloo on the CPU).

Placements are DTensor's: ``(placement over data, placement over model)``,
each ``Shard(dim)`` or ``Replicate()``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

AXES = ("data", "model")
# Calls of each collective, counted where the port issues one.
COLLECTIVES = {"all_gather": 0, "all_reduce": 0}
GROUP_TIMEOUT_S = 120  # a hung collective fails after this, not gloo's 30 minutes


@dataclasses.dataclass(eq=False)
class Mesh:
    """A ``DeviceMesh`` with what the port reads of it: this rank's device,
    the size of each axis (``shape``), this rank's coordinate on each
    (``coords``), and the process group of each of ``('data',)``,
    ``('model',)`` and ``('data', 'model')`` (all ranks of the mesh, in rank
    order)."""

    device_mesh: DeviceMesh
    device: torch.device
    shape: dict
    coords: dict
    groups: dict

    def size(self, axes) -> int:
        n = 1
        for a in _axes(axes):
            n *= self.shape[a]
        return n

    def rank(self, axes) -> int:
        """This rank's index in the group of ``axes`` (row-major)."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        return self.groups[_axes(axes)]


def _axes(axes) -> tuple:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if axes not in (("data",), ("model",), AXES):
        raise ValueError(f"mesh axes {axes!r}: one of 'data', 'model', ('data', 'model')")
    return axes


def host_index() -> int:
    """This process's host (``torchrun``'s ``GROUP_RANK``; 0 without a
    process group)."""
    if not dist.is_initialized():
        return 0
    return int(os.environ.get("GROUP_RANK", 0))


def host_count() -> int:
    """The number of hosts (``WORLD_SIZE / LOCAL_WORLD_SIZE``; 1 without a
    process group)."""
    if not dist.is_initialized():
        return 1
    world = dist.get_world_size()
    return world // int(os.environ.get("LOCAL_WORLD_SIZE", world))


def _local_device(device: torch.device) -> torch.device:
    if device.type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by default; "
                           "pass device='cpu' to run on the CPU")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    return dev


def _start_group(device: torch.device) -> None:
    """A world-size-1 group for ``device`` (NCCL on the card, gloo on the
    CPU), its rendezvous a file in a new temporary directory; or, under
    ``torchrun``, the group its variables describe."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="aznet_mesh_"), "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device="cuda") -> Optional[Mesh]:
    """The ``('data', 'model')`` mesh over the first ``n_devices`` ranks
    (default: all), ``model_parallel`` ranks a model group. Every rank of
    the world calls it (it creates process groups); a rank outside the mesh
    gets None. Without a process group, it starts one: a world of one rank
    (or ``torchrun``'s world), NCCL for ``device='cuda'``, gloo for
    ``'cpu'``. Raises as the reference does when ``n_devices`` is more than
    the world size or not divisible by ``model_parallel``."""
    device = torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else int(
        os.environ.get("WORLD_SIZE", 1))
    n = n_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    local = _local_device(device)
    if not dist.is_initialized():
        _start_group(local)
    backend = dist.get_backend()
    if (backend == "nccl") != (local.type == "cuda"):
        raise ValueError(f"a {local.type} mesh over a {backend} process group: the card "
                         f"takes NCCL, the CPU gloo")
    shape = (n // model_parallel, model_parallel)
    if n == dist.get_world_size():
        dm = init_device_mesh(local.type, shape, mesh_dim_names=AXES)
        flat = dist.group.WORLD
    else:
        dm = DeviceMesh(local.type, torch.arange(n).reshape(shape), mesh_dim_names=AXES)
        flat = dist.new_group(list(range(n)))
    coord = dm.get_coordinate()
    if coord is None:
        return None
    return Mesh(dm, local, dict(zip(AXES, shape)), dict(zip(AXES, coord)),
                {("data",): dm.get_group("data"), ("model",): dm.get_group("model"),
                 AXES: flat})


def replicate(mesh: Mesh) -> tuple:
    """Every rank holds the whole tensor."""
    return (Replicate(), Replicate())


def batch_sharding(mesh: Mesh, ndim: int = 1) -> tuple:
    """The leading (batch) dim split over ``data``, the rest replicated."""
    return (Shard(0), Replicate())


# fc6 and fc7 have their OUTPUT features split over 'model' (dim 0 of a torch
# [out, in] weight, and the bias); the score and box layers stay replicated.
_TP_PATTERN = re.compile(r"(fc6|fc7)$")


def param_sharding(mesh: Mesh, params: dict) -> dict:
    """``{name: placements}`` for a state dict: ``Shard(0)`` over ``model``
    for a weight or bias under a module whose name ends in fc6 or fc7 (the
    reference's rule), replicated elsewhere."""
    def sharded(name, v):
        return v.ndim in (1, 2) and any(_TP_PATTERN.search(p) for p in name.split(".")[:-1])

    return {k: (Replicate(), Shard(0)) if sharded(k, v) else replicate(mesh)
            for k, v in params.items()}


def model_sharded(placements) -> bool:
    return isinstance(placements[1], Shard)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Each rank's ``t`` (equal shapes) concatenated along ``dim`` in group
    rank order, on every rank. Booleans travel as uint8. One buffer, not
    ``dist.all_gather``'s list: on an H100 at 700 W the list form took 241 us of
    host time to issue at world size 1, this one 80 (PERF.md, section 6)."""
    COLLECTIVES["all_gather"] += 1
    n = dist.get_world_size(group)
    x = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    if dim % t.ndim:
        out = torch.cat(out.chunk(n), dim=dim)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, in place in ``t`` (contiguous), returned."""
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(t, group=group)
    return t


def barrier(mesh: Mesh) -> None:
    """Waits for every rank of the mesh (an all-reduce of one element on the
    mesh's device)."""
    all_reduce(torch.zeros(1, device=mesh.device), mesh.group(AXES))


def shard_module(model: torch.nn.Module, mesh: Mesh) -> dict:
    """Hands ``mesh`` to every submodule that has a ``mesh`` attribute (the
    fc stacks, which then run the collectives; a module that cannot run on
    it raises there, before any parameter is split), splits ``model``'s
    fc6/fc7 parameters over ``model`` in place (each rank keeps its rows,
    ``narrow(0, ...)``), and returns the placements."""
    for mod in model.modules():
        if hasattr(mod, "mesh"):
            mod.mesh = mesh
    placements = param_sharding(mesh, dict(model.named_parameters()))
    with torch.no_grad():
        for name, pl in placements.items():
            if model_sharded(pl):
                mod_name, attr = name.rsplit(".", 1)
                mod = model.get_submodule(mod_name)
                setattr(mod, attr, torch.nn.Parameter(local_rows(getattr(mod, attr), mesh)))
    return placements


def local_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's part of ``t`` split over ``model`` along dim 0, a copy."""
    n = mesh.shape["model"]
    if t.shape[0] % n:
        raise ValueError(f"dim 0 of size {t.shape[0]} does not split over model={n}")
    rows = t.shape[0] // n
    return t.narrow(0, mesh.coords["model"] * rows, rows).clone()


def gather_rows(tree: dict, mesh: Mesh, placements: dict) -> dict:
    """``tree`` (``{name: tensor}``, or a nested dict of such) with each
    model-sharded entry gathered over ``model``: the single-process layout.
    Every rank calls it."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = gather_rows(v, mesh, placements)
        elif k in placements and model_sharded(placements[k]):
            out[k] = all_gather(v.detach(), mesh.group("model"))
        else:
            out[k] = v
    return out


def slice_rows(tree: dict, mesh: Mesh, placements: dict) -> dict:
    """The inverse of :func:`gather_rows`: each model-sharded entry cut to
    this rank's rows."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = slice_rows(v, mesh, placements)
        elif k in placements and model_sharded(placements[k]):
            out[k] = local_rows(v, mesh)
        else:
            out[k] = v
    return out
