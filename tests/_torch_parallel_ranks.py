"""The ranks' side of ``tests/test_torch_parallel*.py``: functions that
``aznet_tpu_torch/parallel/multihost.py::launch`` runs in every rank of a
gloo world on the CPU. They import the port only (never JAX: a rank is a
fresh interpreter), read their inputs from ``<dir>/in.pt`` and write their
results to ``<dir>/<rank>.pt``; the test process holds them against the JAX
package and the port's one-process paths."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from aznet_tpu_torch import api
from aznet_tpu_torch.config import Config, cfg_from_dict
from aznet_tpu_torch.parallel import make_mesh, param_sharding
from aznet_tpu_torch.parallel.inference import (make_latency_propose, make_sharded_detect,
                                                make_sharded_propose)
from aznet_tpu_torch.parallel.mesh import COLLECTIVES, host_index, model_sharded
from aznet_tpu_torch.train.loop import make_global_batch, train_az_net
from aznet_tpu_torch.train.train_az import make_az_train_state, make_az_train_step
from aznet_tpu_torch.train.train_frcnn import make_frcnn_train_state, make_frcnn_train_step


def _cfg(over: dict) -> Config:
    return cfg_from_dict(Config(), over)


def host_batch(rows: int) -> dict:
    """A host's batch whose rows name their host and index."""
    pid = host_index()
    tag = np.arange(rows, dtype=np.float32) + 100.0 * pid
    return {"images": np.broadcast_to(tag[:, None, None, None], (rows, 4, 4, 3)).copy(),
            "labels": tag.astype(np.int32)}


def _propose_net(inp):
    return api.build_az_net(_cfg(inp["propose_cfg"]), state_dict=inp["az_params"],
                            device="cpu")


def _errors(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def dp_world(path: str, tools_argv: list) -> None:
    """World 4 on 2 hosts: the meshes' misuse, the global batch on (4, 1)
    and (2, 2), sharded propose and detect on DP=4, and ``train_net --mesh
    2x2`` (AZ-Net, then Fast R-CNN on jittered ground truth)."""
    inp = torch.load(os.path.join(path, "in.pt"), weights_only=False)
    res = {"errors": [_errors(lambda: make_mesh(8, device="cpu")),
                      _errors(lambda: make_mesh(4, model_parallel=3, device="cpu"))]}
    batch = host_batch(inp["host_rows"])
    for mp in (1, 2):
        mesh = make_mesh(4, model_parallel=mp, device="cpu")
        res[f"coords_{mp}"] = (mesh.coords["data"], mesh.coords["model"])
        res[f"rows_{mp}"] = make_global_batch(batch, mesh)["labels"]

    mesh = make_mesh(4, device="cpu")
    net = _propose_net(inp)
    res["propose"] = make_sharded_propose(net.model, net.cfg, inp["canvas"], mesh)(
        torch.from_numpy(inp["images"]))
    fr = api.build_frcnn_net(_cfg(inp["detect_cfg"]), state_dict=inp["fr_params"], device="cpu")
    res["detect"] = make_sharded_detect(fr.model, fr.cfg, inp["canvas"], mesh)(
        torch.from_numpy(inp["images"]), torch.from_numpy(inp["det_boxes"]))
    res["odd_batch"] = _errors(lambda: make_sharded_propose(
        net.model, net.cfg, inp["canvas"], mesh)(torch.from_numpy(inp["images"][:3])))

    from tools_torch import train_net

    res["tool_rc"] = [train_net.main(tools_argv + ["--net", net, "--output",
                                                   os.path.join(path, f"tool_{net}")])
                      for net in ("az", "frcnn")]
    torch.save(res, os.path.join(path, f"{dist.get_rank()}.pt"))


def loop_imdb():
    from aznet_tpu_torch.data.synthetic import SyntheticImdb

    return SyntheticImdb(split="val", seed=1, num_images=8, image_hw=(96, 128))


def _step_rows(inp, mesh, over, steps, kind="az"):
    """``steps`` steps on the mesh, AZ from the converted parameters or Fast
    R-CNN from the seeded init; the metrics of each and the gathered
    snapshot."""
    if kind == "az":
        state = make_az_train_state(_cfg(over), device="cpu", state_dict=inp["train_params"],
                                    mesh=mesh)
        step = make_az_train_step(state.model, mesh=mesh)
    else:
        state = make_frcnn_train_state(_cfg(over), device="cpu", mesh=mesh)
        step = make_frcnn_train_step(state.model, mesh=mesh)
    rows = make_global_batch(inp[f"{kind}_batch"], mesh)
    metrics = [{k: float(v) for k, v in step(state, rows, 7).items()} for _ in range(steps)]
    return metrics, state.snapshot()


def tp_world(path: str) -> None:
    """World 8: the (4, 2) mesh and its sharding rule, region-sharded
    propose on (2, 4), latency propose on all 8 ranks (and at a frontier
    that does not split evenly), the AZ step on (4, 2) without and with
    dropout, the Fast R-CNN step, and ``train_az_net`` on (4, 2): 4 steps from scratch with
    snapshots and mining (``loop``), and 2 more from a one-process snapshot
    of step 2 (``resume``)."""
    inp = torch.load(os.path.join(path, "in.pt"), weights_only=False)
    mesh = make_mesh(8, model_parallel=2, device="cpu")
    res = {"shape": mesh.shape, "coords": (mesh.coords["data"], mesh.coords["model"]),
           "sharded": sorted(k for k, v in param_sharding(mesh, inp["train_params"]).items()
                             if model_sharded(v))}
    net = _propose_net(inp)
    region = make_mesh(8, model_parallel=4, device="cpu")
    res["region"] = make_sharded_propose(net.model, net.cfg, inp["canvas"], region,
                                         shard_regions=True)(torch.from_numpy(inp["images"][:2]))
    res["latency"] = make_latency_propose(net.model, net.cfg, inp["canvas"], mesh)(
        torch.from_numpy(inp["images"][3]))
    odd = api.build_az_net(_cfg(inp["odd_cfg"]), state_dict=inp["az_params"], device="cpu")
    res["latency_odd"] = make_latency_propose(odd.model, odd.cfg, inp["canvas"], mesh)(
        torch.from_numpy(inp["images"][3]))

    c0 = dict(COLLECTIVES)
    res["step"] = _step_rows(inp, mesh, inp["step_cfg"], 2)
    res["step_collectives"] = {k: v - c0[k] for k, v in COLLECTIVES.items()}
    res["dropout_step"] = _step_rows(inp, mesh, inp["dropout_cfg"], 2)
    res["frcnn_step"] = _step_rows(inp, mesh, inp["frcnn_cfg"], 2, "frcnn")

    for key in ("loop", "resume"):
        state, _, _ = train_az_net(_cfg(inp[f"{key}_cfg"]), "synthetic_val", max_iters=4,
                                   output_dir=os.path.join(path, key), imdb=loop_imdb(),
                                   device="cpu", mesh=mesh)
        res[key] = (state.step, state.snapshot()["params"])
    torch.save(res, os.path.join(path, f"{dist.get_rank()}.pt"))
