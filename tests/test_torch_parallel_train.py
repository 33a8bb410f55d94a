"""Port parity, multi-device (2 of 2): the ``{data 4, model 2}`` mesh and
its sharding rule, region-sharded propose (DP 2 x model 4), latency propose
over 8 ranks, the DP x TP train step and ``train_az_net`` under a mesh, on
the CPU with gloo.

The ranks run the port only (``tests/_torch_parallel_ranks.py::tp_world``,
one launch of 8 ranks); the JAX side runs here on the 8-device CPU mesh of
``tests/conftest.py``, with ``tests/test_parallel.py``'s configs and
weights converted by ``params_from_flax``. Tolerances:

- propose: valid masks equal, scores 1e-5, boxes 1e-3 (absolute), as
  ``tests/test_parallel.py``;
- the train step against JAX's sharded step (``DROPOUT`` 0): loss and
  metrics to 1e-4 relative, parameters to 2e-4 absolute, as
  ``test_sharded_step_matches_single_device``, after two steps with
  ``GRAD_CLIP`` biting and ``roi_valid`` uneven over the data shards (all,
  half, one and none of an image's rois), so that a per-shard mean or a
  per-shard clip would fail;
- the mesh step against the port's one-process step, AZ without and with
  dropout (the same masks) and Fast R-CNN (uneven ``roi_valid`` again):
  metrics to 1e-5 relative, parameters to 1e-6 absolute: float32 sums in
  another order;
- ``train_az_net`` on the mesh against one process from the same snapshot:
  the same bounds.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from aznet_tpu import api as japi
from aznet_tpu.config import Config as JConfig
from aznet_tpu.config import cfg_from_dict as jcfg_from_dict
from aznet_tpu.models import AZNet as JAZNet
from aznet_tpu.parallel import batch_sharding, param_sharding, replicate
from aznet_tpu.parallel import make_mesh as jmake_mesh
from aznet_tpu.parallel.inference import make_latency_propose as jlatency
from aznet_tpu.parallel.inference import make_sharded_propose as jsharded_propose
from aznet_tpu.train import make_az_train_state as jmake_state
from aznet_tpu.train import make_az_train_step as jmake_step
from aznet_tpu_torch import api as tapi
from aznet_tpu_torch.config import Config, cfg_from_dict
from aznet_tpu_torch.parallel.multihost import launch
from aznet_tpu_torch.train.loop import train_az_net
from aznet_tpu_torch.train.train_az import make_az_train_state, make_az_train_step
from aznet_tpu_torch.train.train_frcnn import make_frcnn_train_state, make_frcnn_train_step
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
# A frontier of 20 rows (levels of 8 and 20): 20 over 8 ranks pads 4 rows.
ODD = dict(PROPOSE, SEAR=dict(PROPOSE["SEAR"], FRONTIER_CAP=20))
STEP = {
    "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 64, "NUM_TEMPLATES": 5,
              "COMPUTE_DTYPE": "float32", "DROPOUT": 0.0},
    "TRAIN": {"LEARNING_RATE": 0.01, "GRAD_CLIP": 0.2},  # the norm is about 0.44
}
DROPOUT = dict(STEP, MODEL=dict(STEP["MODEL"], DROPOUT=0.5))
LOOP = {
    "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 32, "NUM_TEMPLATES": 5, "NUM_CLASSES": 4,
              "COMPUTE_DTYPE": "float32"},
    "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 2, "NUM_PROPOSALS": 10},
    "TRAIN": {"SCALES": [64], "MAX_SIZE": 96, "REGIONS_PER_IMAGE": 16, "IMS_PER_BATCH": 8,
              "LEARNING_RATE": 0.003, "GRAD_CLIP": 10.0, "USE_FLIPPED": False,
              "SNAPSHOT_ITERS": 2},
    "TEST": {"SCALES": [64], "MAX_SIZE": 96},
}
MINING = dict(LOOP, TRAIN=dict(LOOP["TRAIN"], MINE_INTERVAL=2, MINE_IMAGES=2))
FRCNN = dict(STEP, MODEL=dict(STEP["MODEL"], NUM_CLASSES=4))
CANVAS = (64, 128)
METRIC_RTOL, PARAM_ATOL = 1e-5, 1e-6  # the mesh against one process


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _train_batch(rng, b=8, r=4, k=5):
    """``tests/test_parallel.py::_batch`` with ``roi_valid`` uneven over the
    four data shards of two images each."""
    rois = rng.uniform(0, 40, (b, r, 4)).astype(np.float32)
    rois[..., 2:] += 16.0
    valid = np.zeros((b, r), bool)
    valid[0:2] = True
    valid[2:4, :2] = True
    valid[4:6, 0] = True
    return {
        "images": rng.uniform(-1, 1, (b, 64, 64, 3)).astype(np.float32),
        "rois": rois,
        "roi_valid": valid,
        "zoom_labels": rng.randint(0, 2, (b, r)).astype(np.float32),
        "adj_labels": rng.randint(0, 2, (b, r, k)).astype(np.float32),
        "adj_targets": rng.normal(0, 0.1, (b, r, k, 4)).astype(np.float32),
        "adj_inside": np.ones((b, r, k, 4), np.float32),
    }


def _frcnn_batch(rng, b=8, r=4, c=4):
    """``tests/test_torch_train.py``'s Fast R-CNN batch at 8 images, with
    ``roi_valid`` uneven over the data shards as in :func:`_train_batch`."""
    batch = _train_batch(rng, b, r)
    labels = rng.randint(0, c, (b, r))
    inside = np.zeros((b, r, 4 * c), np.float32)
    for i, j in zip(*np.nonzero(labels)):
        inside[i, j, 4 * labels[i, j]:4 * labels[i, j] + 4] = 1.0
    return {"images": batch["images"], "rois": batch["rois"], "roi_valid": batch["roi_valid"],
            "labels": labels.astype(np.int32), "bbox_inside": inside,
            "bbox_targets": inside * rng.normal(0, 0.1, inside.shape).astype(np.float32)}


def _loop_imdb():
    from aznet_tpu_torch.data.synthetic import SyntheticImdb

    return SyntheticImdb(split="val", seed=1, num_images=8, image_hw=(96, 128))


def _loop(path, over, iters):
    return train_az_net(cfg_from_dict(Config(), over), "synthetic_val", max_iters=iters,
                        output_dir=str(path), imdb=_loop_imdb(), device="cpu")[0]


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp")
    jnet = japi.build_az_net(jcfg_from_dict(JConfig(), PROPOSE))
    jcfg = jcfg_from_dict(JConfig(), STEP)
    jmodel = JAZNet(model_cfg=jcfg.MODEL)
    jstate = jmake_state(jcfg, jmodel, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (8, 96, 128, 3)).astype(np.uint8)
    inp = {"az_params": params_from_flax(_np(jnet.params)), "propose_cfg": PROPOSE,
           "odd_cfg": ODD, "canvas": CANVAS, "images": images,
           "train_params": params_from_flax(_np(jstate.params)),
           "az_batch": _train_batch(rng), "frcnn_batch": _frcnn_batch(rng), "step_cfg": STEP,
           "dropout_cfg": DROPOUT, "frcnn_cfg": FRCNN, "loop_cfg": MINING, "resume_cfg": LOOP}
    torch.save(inp, path / "in.pt")
    # A one-process snapshot of step 2 for the mesh to resume, and its copy
    # for one process to resume.
    _loop(path / "resume", LOOP, 2)
    shutil.copytree(path / "resume", path / "resume_one")
    outs = launch(8, f"{RANKS}:tp_world", (str(path),), timeout=300)
    res = [torch.load(path / f"{r}.pt", weights_only=False) for r in range(8)]
    return {"jnet": jnet, "jmodel": jmodel, "jstate": jstate, "inp": inp, "res": res,
            "outs": outs, "path": path}


def _assert_close(got, want):
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), atol=1e-3, rtol=0)


def _same_on_every_rank(res, key):
    for r in res[1:]:
        for a, b in zip(res[0][key], r[key]):
            assert torch.equal(a, b), key
    return res[0][key]


def _one_process(tp, over):
    return tapi.build_az_net(cfg_from_dict(Config(), over), state_dict=tp["inp"]["az_params"],
                             device="cpu")


def _torch_name(path) -> str:
    """A Flax parameter path as the port names it (``params_from_flax``)."""
    keys = [getattr(p, "key", getattr(p, "name", "")) for p in path][1:]
    return ".".join(keys[:-1] + ["weight" if keys[-1] == "kernel" else keys[-1]])


def test_mesh_shape_and_sharding_rule(tp):
    assert all(r["shape"] == {"data": 4, "model": 2} for r in tp["res"])
    assert [r["coords"] for r in tp["res"]] == [(k // 2, k % 2) for k in range(8)]
    jmesh = jmake_mesh(8, model_parallel=2)
    assert jmesh.devices.shape == (4, 2) and jmesh.axis_names == ("data", "model")
    rules = jax.tree_util.tree_flatten_with_path(param_sharding(jmesh, tp["jstate"].params))[0]
    want = sorted(_torch_name(p) for p, s in rules if s.spec != P())
    assert want == ["head.fc.fc6.bias", "head.fc.fc6.weight", "head.fc.fc7.bias",
                    "head.fc.fc7.weight"]
    assert tp["res"][0]["sharded"] == want


def test_region_sharded_propose_matches_jax_and_one_process(tp):
    got = _same_on_every_rank(tp["res"], "region")
    images = tp["inp"]["images"][:2]
    cfg = jcfg_from_dict(JConfig(), PROPOSE)
    mesh = jmake_mesh(8, model_parallel=4)
    with mesh:
        want = jsharded_propose(tp["jnet"].model, cfg, CANVAS, mesh, shard_regions=True)(
            tp["jnet"].params, jnp.asarray(images))
    _assert_close(got, want)
    net = _one_process(tp, PROPOSE)
    _assert_close(got, tapi.make_propose_batch(net.model, net.cfg, CANVAS)(
        torch.from_numpy(images)))


@pytest.mark.parametrize("key,over", [("latency", PROPOSE), ("latency_odd", ODD)])
def test_latency_propose_matches_jax_and_one_process(tp, key, over):
    got = _same_on_every_rank(tp["res"], key)
    image = tp["inp"]["images"][3]
    cfg = jcfg_from_dict(JConfig(), over)
    jnet = tp["jnet"]
    single = jax.jit(japi.make_propose_batch(jnet.model, cfg, CANVAS))(
        jnet.params, jnp.asarray(image[None]))
    _assert_close(got, [t[0] for t in single])
    if key == "latency":
        mesh = jmake_mesh(8, model_parallel=2)
        with mesh:
            _assert_close(got, jlatency(jnet.model, cfg, CANVAS, mesh)(
                jnet.params, jnp.asarray(image)))
    net = _one_process(tp, over)
    _assert_close(got, [t[0] for t in tapi.make_propose_batch(net.model, net.cfg, CANVAS)(
        torch.from_numpy(image[None]))])


def _jax_sharded_steps(tp, steps=2):
    jmesh = jmake_mesh(8, model_parallel=2)
    state = tp["jstate"]
    state = jax.device_put(state, jax.tree_util.tree_map(
        lambda _: replicate(jmesh), state, is_leaf=lambda x: hasattr(x, "ndim"),
    ).replace(params=param_sharding(jmesh, state.params)))
    batch = {k: jax.device_put(jnp.asarray(v), batch_sharding(jmesh, v.ndim))
             for k, v in tp["inp"]["az_batch"].items()}
    step = jax.jit(jmake_step(tp["jmodel"]))
    metrics = []
    with jmesh:
        for _ in range(steps):
            state, m = step(state, batch, jax.random.PRNGKey(7))
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, params_from_flax(_np(jax.device_get(state.params)))


def _port_steps(tp, over, steps=2, kind="az"):
    cfg = cfg_from_dict(Config(), over)
    if kind == "az":
        state = make_az_train_state(cfg, device="cpu", state_dict=tp["inp"]["train_params"])
        step = make_az_train_step(state.model)
    else:
        state = make_frcnn_train_state(cfg, device="cpu")
        step = make_frcnn_train_step(state.model)
    metrics = [{k: float(v) for k, v in step(state, tp["inp"][f"{kind}_batch"], 7).items()}
               for _ in range(steps)]
    return metrics, state.model.state_dict()


def _assert_steps(got, want, rtol, atol):
    (g_metrics, g_params), (w_metrics, w_params) = got, want
    for g, w in zip(g_metrics, w_metrics):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)
    assert set(g_params) == set(w_params)
    for k in w_params:
        np.testing.assert_allclose(g_params[k].numpy(), np.asarray(w_params[k]), atol=atol,
                                   rtol=0, err_msg=k)


def _mesh_steps(tp, key):
    metrics, snap = tp["res"][0][key]
    for r in tp["res"][1:]:
        assert r[key][0] == metrics
        assert all(torch.equal(snap["params"][k], v) for k, v in r[key][1]["params"].items())
    return metrics, snap["params"]


def test_train_step_matches_jax_sharded_step(tp):
    got = _mesh_steps(tp, "step")
    assert all(m["grad_norm"] > STEP["TRAIN"]["GRAD_CLIP"] for m in got[0])  # the clip bites
    _assert_steps(got, _jax_sharded_steps(tp), 1e-4, 2e-4)


@pytest.mark.parametrize("key,over,kind", [("step", STEP, "az"), ("dropout_step", DROPOUT, "az"),
                                           ("frcnn_step", FRCNN, "frcnn")])
def test_train_step_matches_one_process(tp, key, over, kind):
    _assert_steps(_mesh_steps(tp, key), _port_steps(tp, over, kind=kind), METRIC_RTOL,
                  PARAM_ATOL)


def test_train_step_collectives(tp):
    """Per step: one all-reduce of the gradients and one of the metrics over
    data, one per normaliser (3), one of the sharded norms over model (with
    the clip's, 2), one per fc layer backward (2); fc6 and fc7 gather their
    features (2)."""
    calls = tp["res"][0]["step_collectives"]
    assert calls["all_reduce"] == 2 * (2 + 3 + 2 + 2)
    assert calls["all_gather"] == 2 * 2 + 2 * 4  # the steps, then the snapshot's 4 tensors x 2


def test_loop_snapshot_restores_in_one_process(tp):
    """4 steps from scratch on the mesh, mining every 2: its snapshot of step
    4 loads into a one-process state as the gathered parameters."""
    step, params = tp["res"][0]["loop"]
    assert step == 4 and all(r["loop"][0] == 4 for r in tp["res"])
    assert all(torch.isfinite(v).all() for v in params.values())
    assert "[az] mined search regions for 2 images at step 2" in tp["outs"][0]
    ckpt = Checkpointer(str(tp["path"] / "loop"), prefix=Config().TRAIN.SNAPSHOT_PREFIX)
    assert ckpt.all_steps() == [2, 4]
    state = make_az_train_state(cfg_from_dict(Config(), MINING), device="cpu")
    state.restore(ckpt.restore({"params": 0, "opt_state": 0, "step": 0})[0])
    assert state.step == 4
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, params[k]), k


def test_loop_resumes_a_one_process_snapshot(tp):
    """The mesh resumes a one-process snapshot of step 2 and trains to 4 as
    one process does from the same snapshot."""
    assert "[az] resumed from step 2" in tp["outs"][0]
    step, params = tp["res"][0]["resume"]
    assert step == 4
    one = _loop(tp["path"] / "resume_one", LOOP, 4)
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)
