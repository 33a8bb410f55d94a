"""Port parity: the Caffe weight converter (``utils/convert_weights.py``),
the two small helpers (``ops/iou.py::intersection_over_area``,
``ops/nms.py::nms_jax``) and ``utils/profiling.py``.

- The converter: on random Caffe arrays of each Caffe-lineage trunk
  (VGG-16 at WIDTH 0.125, CaffeNet, VGG_CNN_M_1024) with an AZ head and a
  Fast R-CNN head, the reference's conversion followed by
  ``utils/convert.py::params_from_flax`` equals the port's direct
  conversion bit for bit. A snapshot of ``convert_npz_to_checkpoint``
  loaded by ``build_az_net`` proposes as the JAX net on the reference's
  conversion, at ``tests/test_torch_api.py``'s bounds (scores 1e-5, boxes
  2e-3 px, the number of proposals exactly).
- The helpers against JAX, exactly, with zero-area and degenerate boxes.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aznet_tpu import api as japi
from aznet_tpu.config import Config as JConfig, cfg_from_dict as jcfg_from_dict
from aznet_tpu.ops.iou import intersection_over_area as j_ioa
from aznet_tpu.utils import convert_weights as jconv
from aznet_tpu_torch import api as tapi
from aznet_tpu_torch.config import Config, cfg_from_dict
from aznet_tpu_torch.ops.iou import intersection_over_area
from aznet_tpu_torch.ops.nms import nms_jax
from aznet_tpu_torch.utils import convert_weights as tconv
from aznet_tpu_torch.utils import profiling
from aznet_tpu_torch.utils.checkpoint import Checkpointer
from aznet_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(2)
jnms = importlib.import_module("aznet_tpu.ops.nms")

MODEL = {"FC_DIM": 32, "NUM_TEMPLATES": 5, "NUM_CLASSES": 4, "COMPUTE_DTYPE": "float32"}
TRUNKS = {"vgg16": {"BACKBONE": "vgg16", "WIDTH": 0.125},
          "caffenet": {"BACKBONE": "caffenet", "POOL_SIZE": 6},
          "vgg_cnn_m_1024": {"BACKBONE": "vgg_cnn_m_1024", "POOL_SIZE": 6}}
SEARCH = {"SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 2, "NUM_PROPOSALS": 10},
          "TEST": {"SCALES": [64], "MAX_SIZE": 128}}


def _caffe(arch, net, seed=0):
    """Random Caffe arrays ``{layer: (W, b)}`` of the port's ``net`` over
    ``arch`` (a Caffe conv ``(out, in, kh, kw)`` and Dense ``(out, in)`` have
    the port's shapes), He-scaled so that activations stay in range."""
    cfg = cfg_from_dict(Config(), {"MODEL": {**MODEL, **TRUNKS[arch]}})
    params = (tapi.build_az_net if net == "az" else tapi.build_frcnn_net)(cfg, device="cpu").params
    rng = np.random.RandomState(seed)
    out = {}
    for key, v in params.items():
        if key.endswith(".weight"):
            fan_in = int(np.prod(v.shape[1:]))
            out[key.split(".")[-2]] = (
                (rng.standard_normal(tuple(v.shape)) * np.sqrt(2.0 / fan_in)).astype(np.float32),
                (rng.standard_normal(v.shape[0]) * 0.01).astype(np.float32))
    return cfg, out


@pytest.mark.parametrize("net", ["az", "frcnn"])
@pytest.mark.parametrize("arch", sorted(TRUNKS))
def test_conversion_equals_reference_then_params_from_flax(arch, net):
    cfg, caffe = _caffe(arch, net)
    pool, channels = cfg.MODEL.POOL_SIZE, caffe[tconv._TRUNK_LAYOUTS[arch][0][-1]][1].shape[0]
    if net == "az":
        j_head = jconv.convert_az_head(caffe, pool=pool, channels=channels)
        t_head = tconv.convert_az_head(caffe, pool=pool, channels=channels)
    else:
        j_head = jconv.convert_frcnn_head(caffe, pool=pool, channels=channels)
        t_head = tconv.convert_frcnn_head(caffe, pool=pool, channels=channels)
    want = params_from_flax({"params": {"trunk": jconv.convert_trunk(caffe, arch),
                                        "head": j_head}})
    got = {**tconv.convert_trunk(caffe, arch), **t_head}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k
    # ...and the names and shapes are the port's net's.
    model = (tapi.build_az_net if net == "az" else tapi.build_frcnn_net)(cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in model.params.items()}


def test_fc6_rows_take_the_nhwc_flatten():
    """Caffe's fc6 input ``c * P * P + ph * P + pw`` lands on the port's
    ``ph * P * C + pw * C + c``."""
    p, c = 3, 4
    w = np.arange(2 * c * p * p, dtype=np.float32).reshape(2, c * p * p)
    got = tconv.convert_fc6(w, np.zeros(2, np.float32), pool=p, channels=c)["head.fc.fc6.weight"]
    for ph, pw, ch in ((0, 0, 1), (2, 1, 3), (1, 2, 0)):
        assert got[1, ph * p * c + pw * c + ch] == w[1, ch * p * p + ph * p + pw]


def test_npz_snapshot_proposes_as_the_jax_net(tmp_path):
    cfg, caffe = _caffe("vgg16", "az", seed=1)
    cfg = cfg_from_dict(cfg, SEARCH)
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **{f"{k}_W": w for k, (w, _) in caffe.items()},
             **{f"{k}_b": b for k, (_, b) in caffe.items()})
    sd = tconv.convert_npz_to_checkpoint(npz, str(tmp_path / "ckpt"), arch="az",
                                         backbone="vgg16", channels=64)
    restored, step = Checkpointer(str(tmp_path / "ckpt")).restore({"params": 0})
    assert step == 0 and set(restored["params"]) == set(sd)
    tnet = tapi.build_az_net(cfg, state_dict=restored["params"], device="cpu")

    jcfg = jcfg_from_dict(JConfig(), {"MODEL": {**MODEL, **TRUNKS["vgg16"]}, **SEARCH})
    loaded = jconv.load_npz(npz)
    jnet = japi.build_az_net(jcfg)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, {"params": {
        "trunk": jconv.convert_trunk(loaded, "vgg16"),
        "head": jconv.convert_az_head(loaded, pool=7, channels=64)}})
    for seed, hw in ((0, (100, 150)), (2, (90, 140))):
        im = np.random.RandomState(seed).randint(0, 256, hw + (3,)).astype(np.uint8)
        got, want = tapi.im_propose(tnet, im), np.asarray(japi.im_propose(jnet, im))
        assert got.shape == want.shape and 0 < got.shape[0] <= 10
        np.testing.assert_allclose(got[:, 4], want[:, 4], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=2e-3, rtol=0)


def test_trunk_only_snapshot(tmp_path):
    _, caffe = _caffe("caffenet", "az")
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **{f"{k}_W": w for k, (w, _) in caffe.items()},
             **{f"{k}_b": b for k, (_, b) in caffe.items()})
    sd = tconv.convert_npz_to_checkpoint(npz, str(tmp_path / "ckpt"), arch="caffenet")
    assert sorted(sd) == sorted(f"trunk.conv{i}.{p}" for i in range(1, 6)
                                for p in ("weight", "bias"))
    with pytest.raises(KeyError, match="conv5"):
        tconv.convert_trunk({k: v for k, v in caffe.items() if k != "conv5"}, "caffenet")


def _boxes(seed, n):
    """Boxes in [0, 60] with zero-area (x2 = x1 - 1 at offset 1, x2 = x1 at
    offset 0) and degenerate (x2 < x1) rows."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 40, (n, 2)).astype(np.float32)
    wh = rng.uniform(-3, 20, (n, 2)).astype(np.float32)
    b = np.concatenate([xy, xy + wh], 1)
    if n >= 3:
        b[0, 2], b[1, 3], b[2, 2:] = b[0, 0] - 1, b[1, 1], b[2, :2] - 5
    return b


@pytest.mark.parametrize("offset", [1.0, 0.0])
@pytest.mark.parametrize("n,k", [(7, 5), (40, 33), (1, 1), (3, 1)])
def test_intersection_over_area_matches_jax(n, k, offset):
    a, b = _boxes(n, n), _boxes(k + 100, k)
    got = intersection_over_area(torch.from_numpy(a), torch.from_numpy(b), offset).numpy()
    want = np.asarray(j_ioa(jnp.asarray(a), jnp.asarray(b), offset))
    assert got.dtype == np.float32 and got.shape == (n, k)
    np.testing.assert_array_equal(got, want)
    area = (a[:, 2] - a[:, 0] + offset) * (a[:, 3] - a[:, 1] + offset)
    assert (got[area <= 0] == 0).all()


@pytest.mark.parametrize("thresh", [0.3, 0.7])
@pytest.mark.parametrize("n", [1, 12, 200])
def test_nms_jax_matches_jax(n, thresh):
    rng = np.random.RandomState(n)
    dets = np.concatenate([_boxes(n + 7, n), rng.randint(0, 5, (n, 1)).astype(np.float32) / 4],
                          1)  # tied scores
    valid = rng.uniform(size=n) > 0.2
    for v in (None, valid):
        got = nms_jax(torch.from_numpy(dets), thresh,
                      None if v is None else torch.from_numpy(v)).numpy()
        want = np.asarray(jnms.nms_jax(jnp.asarray(dets), thresh,
                                       None if v is None else jnp.asarray(v)))
        np.testing.assert_array_equal(got, want)


def test_block_timer_prints_and_returns_seconds(capsys):
    x = torch.ones(4)
    with profiling.block_timer("add", {"x": [x], "y": (x,)}) as t:
        x.add_(1)
    assert t["seconds"] >= 0.0
    assert capsys.readouterr().out.startswith("[timer] add: ")
    with profiling.block_timer("none") as t2:
        pass
    assert "seconds" in t2


def test_trace_writes_a_chrome_trace(tmp_path):
    import json

    with profiling.trace(str(tmp_path / "tb")) as prof:
        with profiling.span("outer"):
            with profiling.span("inner", image=0):
                torch.ones(64, 64).matmul(torch.ones(64, 64))
    with open(tmp_path / "tb" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
    # The spans recorded while the trace ran, on the perf_counter_ns clock.
    with open(tmp_path / "tb" / "spans.json") as f:
        record = json.load(f)
    assert record["dropped"] == 0 and record["profiler_offset_ns"] is None  # no card
    inner, outer = record["spans"]
    assert (outer["name"], outer["parent"], outer["call"]) == ("outer", None, outer["id"])
    assert (inner["name"], inner["parent"], inner["call"]) == ("inner", outer["id"], outer["id"])
    assert inner["attrs"] == {"image": 0}
    assert outer["start"] <= inner["start"] <= inner["end"] <= outer["end"]
    with profiling.trace(str(tmp_path / "tb2")):
        pass
    with open(tmp_path / "tb2" / "spans.json") as f:
        assert json.load(f)["spans"] == []  # only the spans of its own session


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == {}
