"""Port parity, multi-device (1 of 2): the mesh's rules, the multi-host
input path, sharded propose and detect (DP=4), ``train_net --mesh 2x2``
and the two-host dry run, on the CPU with gloo.

The ranks run the port only (``tests/_torch_parallel_ranks.py::dp_world``,
one launch of 4 ranks on 2 hosts through
``aznet_tpu_torch/parallel/multihost.py::launch``); the JAX side runs here,
on the 8-device CPU mesh of ``tests/conftest.py``, with the smallnet
configs of ``tests/test_parallel.py``, its weights converted by
``params_from_flax``. Tolerances are ``tests/test_parallel.py``'s: valid
masks equal, scores 1e-5, boxes 1e-3 (absolute), against JAX's sharded
function and the port's one-process batch function alike.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aznet_tpu import api as japi
from aznet_tpu.config import Config as JConfig
from aznet_tpu.config import cfg_from_dict as jcfg_from_dict
from aznet_tpu.parallel import make_mesh as jmake_mesh
from aznet_tpu.parallel.inference import make_sharded_detect as jsharded_detect
from aznet_tpu.parallel.inference import make_sharded_propose as jsharded_propose
from aznet_tpu.train import loop as jloop
from aznet_tpu_torch import api as tapi
from aznet_tpu_torch.config import Config, cfg_from_dict
from aznet_tpu_torch.parallel.multihost import launch, run_multihost_dryrun
from aznet_tpu_torch.train import loop as tloop
from aznet_tpu_torch.utils.checkpoint import Checkpointer
from aznet_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_parallel_ranks.py")
PROPOSE = {
    "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 32, "NUM_TEMPLATES": 5,
              "COMPUTE_DTYPE": "float32"},
    "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 2, "NUM_PROPOSALS": 10},
    "TEST": {"SCALES": [64], "MAX_SIZE": 128},
}
DETECT = {
    "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 32, "NUM_TEMPLATES": 5, "NUM_CLASSES": 4,
              "COMPUTE_DTYPE": "float32"},
    "TEST": {"SCALES": [64], "MAX_SIZE": 128},
}
CANVAS = (64, 128)
HOST_ROWS = 4  # each host's batch; the global batch is 8
TOOL_SET = [
    "--set", "MODEL.BACKBONE", "smallnet", "MODEL.FC_DIM", "32", "MODEL.NUM_TEMPLATES", "5",
    "MODEL.NUM_CLASSES", "4", "MODEL.COMPUTE_DTYPE", "float32", "TRAIN.SCALES", "(64,)",
    "TRAIN.MAX_SIZE", "96", "TRAIN.REGIONS_PER_IMAGE", "16", "TRAIN.USE_FLIPPED", "False",
    "TRAIN.IMS_PER_BATCH", "4",
]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    path = tmp_path_factory.mktemp("dp")
    jnet = japi.build_az_net(jcfg_from_dict(JConfig(), PROPOSE))
    jfr = japi.build_frcnn_net(jcfg_from_dict(JConfig(), DETECT))
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (8, 96, 128, 3)).astype(np.uint8)
    det_boxes = rng.uniform(0, 60, (8, 4, 4)).astype(np.float32)
    det_boxes[..., 2:] += 30.0
    inp = {"az_params": params_from_flax(_np(jnet.params)),
           "fr_params": params_from_flax(_np(jfr.params)), "propose_cfg": PROPOSE,
           "detect_cfg": DETECT, "canvas": CANVAS, "images": images, "det_boxes": det_boxes,
           "host_rows": HOST_ROWS}
    torch.save(inp, path / "in.pt")
    argv = ["--cpu", "--mesh", "2x2", "--imdb", "synthetic_val", "--iters", "2"] + TOOL_SET
    outs = launch(4, f"{RANKS}:dp_world", (str(path), argv), hosts=2, timeout=240)
    res = [torch.load(path / f"{r}.pt", weights_only=False) for r in range(4)]
    return {"jnet": jnet, "jfr": jfr, "inp": inp, "res": res, "outs": outs, "path": path}


def _assert_close(got, want):
    """(boxes, scores, valid) within tests/test_parallel.py's bounds."""
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), atol=1e-3, rtol=0)


def _same_on_every_rank(res, key):
    for r in res[1:]:
        for a, b in zip(res[0][key], r[key]):
            assert torch.equal(a, b), key
    return res[0][key]


def test_make_mesh_misuse_raises_as_the_reference(dp):
    too_many, indivisible = dp["res"][0]["errors"]
    with pytest.raises(ValueError) as jerr:
        jmake_mesh(16)
    assert too_many == "requested 8 devices, have 4"
    assert str(jerr.value) == "requested 16 devices, have 8"
    with pytest.raises(ValueError) as jerr:
        jmake_mesh(4, model_parallel=3)
    assert indivisible == str(jerr.value) == "4 devices not divisible by model_parallel=3"


@pytest.mark.parametrize("mp", [1, 2])
def test_mesh_coordinates_are_row_major(dp, mp):
    assert [r[f"coords_{mp}"] for r in dp["res"]] == [(k // mp, k % mp) for k in range(4)]


@pytest.mark.parametrize("pid,pcount", [(0, 1), (0, 2), (1, 2)])
def test_host_shards_match_reference(monkeypatch, pid, pcount):
    monkeypatch.setattr(jax, "process_index", lambda: pid)
    monkeypatch.setattr(jax, "process_count", lambda: pcount)
    for n in (1, 5, 8):
        assert tloop.process_local_indices(n, pid, pcount) == jloop.process_local_indices(n)
    for ims in (2, 8):
        assert tloop.local_batch_size(ims, pcount) == jloop.local_batch_size(ims)
    if pcount > 1:
        with pytest.raises(ValueError, match="divisible"):
            jloop.local_batch_size(3)
        with pytest.raises(ValueError, match="divisible"):
            tloop.local_batch_size(3, pcount)


@pytest.mark.parametrize("mp", [1, 2])
def test_global_batch_matches_reference_assembly(dp, mp):
    """Two hosts of two ranks: each rank's rows are those that the device at
    its mesh position holds of the reference's global array, made from the
    two hosts' batches in host order."""
    hosts = [np.arange(HOST_ROWS, dtype=np.int32) + 100 * pid for pid in range(2)]
    mesh = jmake_mesh(4, model_parallel=mp)
    glob = jloop.make_global_batch({"labels": np.concatenate(hosts)}, mesh)["labels"]
    by_device = {s.device: np.asarray(s.data) for s in glob.addressable_shards}
    for rank, r in enumerate(dp["res"]):
        want = by_device[mesh.devices[rank // mp, rank % mp]]
        np.testing.assert_array_equal(np.asarray(r[f"rows_{mp}"]), want)


def test_sharded_propose_dp4_matches_jax_and_one_process(dp):
    got = _same_on_every_rank(dp["res"], "propose")
    images = dp["inp"]["images"]
    cfg = jcfg_from_dict(JConfig(), PROPOSE)
    mesh = jmake_mesh(8, model_parallel=1)
    with mesh:
        want = jsharded_propose(dp["jnet"].model, cfg, CANVAS, mesh)(
            dp["jnet"].params, jnp.asarray(images))
    _assert_close(got, want)
    net = tapi.build_az_net(cfg_from_dict(Config(), PROPOSE), state_dict=dp["inp"]["az_params"],
                            device="cpu")
    _assert_close(got, tapi.make_propose_batch(net.model, net.cfg, CANVAS)(
        torch.from_numpy(images)))
    assert "does not split over data=4" in dp["res"][0]["odd_batch"]


def test_sharded_detect_dp4_matches_jax_and_one_process(dp):
    scores, preds = _same_on_every_rank(dp["res"], "detect")
    images, boxes = dp["inp"]["images"], dp["inp"]["det_boxes"]
    cfg = jcfg_from_dict(JConfig(), DETECT)
    mesh = jmake_mesh(8, model_parallel=1)
    with mesh:
        want = jsharded_detect(dp["jfr"].model, cfg, CANVAS, mesh)(
            dp["jfr"].params, jnp.asarray(images), jnp.asarray(boxes))
    fr = tapi.build_frcnn_net(cfg_from_dict(Config(), DETECT), state_dict=dp["inp"]["fr_params"],
                              device="cpu")
    one = tapi.make_detect_batch(fr.model, fr.cfg, CANVAS)(torch.from_numpy(images),
                                                           torch.from_numpy(boxes))
    for ref in (want, one):
        np.testing.assert_allclose(scores.numpy(), np.asarray(ref[0]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(preds.numpy(), np.asarray(ref[1]), atol=1e-3, rtol=0)


@pytest.mark.parametrize("net", ["az", "frcnn"])
def test_train_net_mesh_2x2(dp, net):
    """``tools_torch/train_net.py --cpu --mesh 2x2`` under the launcher: 2
    steps on a (data 2, model 2) mesh over the two hosts, AZ-Net and Fast
    R-CNN (``train_frcnn_net(mesh=)``)."""
    assert [r["tool_rc"] for r in dp["res"]] == [[0, 0]] * 4
    out, tool_out = dp["outs"][0], str(dp["path"] / f"tool_{net}")
    assert "mesh: {'data': 2, 'model': 2}" in out and f"[{net} 2]" in out
    assert f"done; checkpoints in {tool_out}" in out
    assert f"[{net} 2]" not in dp["outs"][1]  # rank 0 alone logs
    for d in (tool_out, f"{tool_out}/deploy"):
        prefix = Config().TRAIN.SNAPSHOT_PREFIX if d == tool_out else "aznet"
        snap = Checkpointer(d, prefix=prefix)
        assert snap.all_steps() == [2]
        params = snap.restore({"params": 0})[0]["params"]
        assert params["head.fc.fc6.weight"].shape[0] == 32  # gathered: the whole fc6
        assert all(torch.isfinite(v).all() for v in params.values())


def test_two_host_dryrun():
    """The multi-host input path: 2 hosts x 2 ranks, each host its roidb
    shard and its local batch, one step on (data 2, model 2)."""
    report = run_multihost_dryrun(num_processes=2, devices_per_proc=2, timeout=240)
    assert report.startswith("dryrun_multihost: processes=2 devices=4 "
                             "mesh={'data': 2, 'model': 2} global_batch=4 loss=")
    assert report.endswith(" OK")
    with pytest.raises(ValueError, match="devices_per_proc"):
        run_multihost_dryrun(num_processes=2, devices_per_proc=1)
