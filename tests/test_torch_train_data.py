"""Port parity, the training data: labels, the search oracle, minibatches and
the multi-process batch stream, each against the JAX package on the same
seeds, equal bit for bit.

Images go through each package's host ``prep_blob`` on a fixed canvas. The
JAX package loads the library its Makefile builds (``-march=native``, where
GCC contracts the bilinear blend into FMAs: 3.05e-5 apart,
``tests/test_torch_host.py``), so these tests hand the JAX package the
port's build of the same source (``utils/native.py``), which the host tests
hold bit-equal to that source built with the port's flags. The NumPy resize
branch (no canvas) needs nothing of the kind.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax

from aznet_tpu.config import Config as JConfig
from aznet_tpu.config import cfg_from_dict as jcfg_from_dict
from aznet_tpu.data import imdb as jimdb
from aznet_tpu.data import minibatch as jmb
from aznet_tpu.data import prefetch as jprefetch
from aznet_tpu.search import oracle as joracle
from aznet_tpu.search.templates import adjacency_templates_np
from aznet_tpu.train import labels as jlabels
from aznet_tpu.utils import native as jnative
from aznet_tpu_torch.config import Config, SearchConfig, cfg_from_dict
from aznet_tpu_torch.data import imdb as timdb
from aznet_tpu_torch.data import minibatch as tmb
from aznet_tpu_torch.data import prefetch as tprefetch
from aznet_tpu_torch.search import oracle as toracle
from aznet_tpu_torch.train import labels as tlabels
from aznet_tpu_torch.utils import native as tnative

torch.set_num_threads(2)

OVERRIDES = {
    "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 32, "NUM_TEMPLATES": 11, "NUM_CLASSES": 4,
              "COMPUTE_DTYPE": "float32", "DROPOUT": 0.0},
    "TRAIN": {"SCALES": [96, 112], "MAX_SIZE": 160, "REGIONS_PER_IMAGE": 32,
              "IMS_PER_BATCH": 2, "BATCH_SIZE": 32, "USE_FLIPPED": True,
              "SNAPSHOT_ITERS": 10000},
    "TEST": {"SCALES": [96], "MAX_SIZE": 160},
}
JCFG, TCFG = jcfg_from_dict(JConfig(), OVERRIDES), cfg_from_dict(Config(), OVERRIDES)


@pytest.fixture(autouse=True)
def _same_prep_blob(monkeypatch):
    """The JAX package's minibatch code calls the port's build of the host
    library's ``prep_blob`` (module docstring)."""
    monkeypatch.setattr(jnative, "prep_blob", tnative.prep_blob)
    monkeypatch.setattr(jnative, "available", lambda: True)


def _assert_equal_trees(want, got, where=""):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), (where, sorted(want), sorted(got))
        for k in want:
            _assert_equal_trees(want[k], got[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), where
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_equal_trees(w, g, f"{where}[{i}]")
    else:
        w, g = np.asarray(want), np.asarray(got)
        assert w.dtype == g.dtype and w.shape == g.shape, (where, w.dtype, g.dtype, w.shape,
                                                           g.shape)
        np.testing.assert_array_equal(g, w, err_msg=where)


def _imdbs(name, flipped=False):
    j, t = jimdb.get_imdb(name), timdb.get_imdb(name)
    if flipped:
        j.append_flipped_images()
        t.append_flipped_images()
    return j, t


# -- labels -----------------------------------------------------------------------


@pytest.mark.parametrize("levels,min_size,div_overlap", [(3, 0.0, 0.0), (4, 24.0, 0.1)])
def test_division_tree_regions_equal(levels, min_size, div_overlap):
    for hw in ((96, 128), (375, 500)):
        _assert_equal_trees(
            jlabels.division_tree_regions(hw, levels, min_size=min_size, div_overlap=div_overlap),
            tlabels.division_tree_regions(hw, levels, min_size=min_size, div_overlap=div_overlap))


def test_perturb_labels_and_sampling_equal():
    _, imdb = _imdbs("synthetic_hard_val")
    templates = adjacency_templates_np(11)
    for i, entry in enumerate(imdb.roidb[:6]):
        gt, hw = entry["boxes"], (entry["height"], entry["width"])
        extra = np.random.RandomState(i).uniform(0, 300, (20, 4)).astype(np.float32)
        extra[:, 2:] += extra[:, :2]
        outs = []
        for lab in (jlabels, tlabels):
            rng = np.random.RandomState(i)
            jit = lab.perturb_gt_regions(gt, hw, 8, rng)
            regions = lab.sample_az_regions(gt, hw, TCFG.TRAIN, rng, extra=extra,
                                            div_overlap=0.05)
            labels = lab.az_labels_for_regions(regions, gt, TCFG.TRAIN, templates)
            outs.append((jit, regions, labels, rng.randint(1 << 30)))
        _assert_equal_trees(*outs, where=f"image {i}")
        assert outs[0][2]["adj_labels"].any() and outs[0][2]["zoom_labels"].any()
    empty = np.zeros((0, 4), np.float32)
    _assert_equal_trees(
        jlabels.az_labels_for_regions(outs[0][1], empty, TCFG.TRAIN, templates),
        tlabels.az_labels_for_regions(outs[0][1], empty, TCFG.TRAIN, templates))


def test_compute_bbox_target_stats_equal():
    j, t = _imdbs("synthetic_train")
    _assert_equal_trees(jlabels.compute_bbox_target_stats(j, JCFG, max_images=12),
                        tlabels.compute_bbox_target_stats(t, TCFG, max_images=12))


# -- the search oracle --------------------------------------------------------------


def _roi_forward(feat, rois):
    """A deterministic head of the rois alone (NumPy): logits that vary with
    the region's place and size."""
    r = np.asarray(rois, np.float64)
    w, h = r[:, 2] - r[:, 0] + 1, r[:, 3] - r[:, 1] + 1
    zoom = np.sin(r[:, 0] * 0.07 + r[:, 1] * 0.05) * 2 + np.log(w * h) * 0.3 - 1.0
    k = np.arange(11)
    adj = np.cos(r[:, 0:1] * 0.03 * (k + 1) + r[:, 3:4] * 0.02) * 3
    delta = np.sin(r[:, None, :] * 0.01 * (k[:, None] + 1)) * 0.2
    return {"zoom": zoom.astype(np.float32), "adj_score": adj.astype(np.float32),
            "adj_delta": delta.astype(np.float32)}


@pytest.mark.parametrize("capped", [True, False])
def test_az_search_oracle_equal(capped):
    for scfg in (SearchConfig(), SearchConfig(FRONTIER_CAP=16, CAND_BUF=256, MAX_LEVELS=4,
                                              NUM_PROPOSALS=50, DIV_OVERLAP=0.1)):
        from aznet_tpu.config import SearchConfig as JSearchConfig

        jscfg = JSearchConfig(**{k: getattr(scfg, k) for k in scfg.__dataclass_fields__})
        want = joracle.az_search_oracle(_roi_forward, None, (375, 500), jscfg, capped=capped)
        got = toracle.az_search_oracle(_roi_forward, None, (375, 500), scfg, capped=capped)
        assert len(want[0]) > 10
        _assert_equal_trees(want, got)


# -- minibatches ---------------------------------------------------------------------


@pytest.mark.parametrize("canvas", [True, False], ids=["prep_blob", "numpy_resize"])
def test_az_minibatch_equal(canvas):
    """synthetic_hard_val (375x500, difficult objects) with flipped entries
    and mined regions."""
    j, t = _imdbs("synthetic_hard_val", flipped=True)
    assert jmb.fixed_canvas(j, JCFG) == tmb.fixed_canvas(t, TCFG)
    cv = tmb.fixed_canvas(t, TCFG) if canvas else None
    picks = [0, 1, 70, 5]  # 70: a flipped entry
    assert any(t.roidb[i]["difficult"].any() for i in picks)
    mined = [None, np.random.RandomState(0).uniform(0, 200, (30, 4)).astype(np.float32),
             None, np.zeros((0, 4), np.float32)]
    mined[1][:, 2:] += mined[1][:, :2]
    for a, b in ((0, 2), (2, 4)):
        want = jmb.get_az_minibatch(j, [j.roidb[i] for i in picks[a:b]], JCFG,
                                    np.random.RandomState(a), cv, mined_by_entry=mined[a:b])
        got = tmb.get_az_minibatch(t, [t.roidb[i] for i in picks[a:b]], TCFG,
                                   np.random.RandomState(a), cv, mined_by_entry=mined[a:b])
        _assert_equal_trees(want, got)
        assert got["roi_valid"].all() and got["adj_labels"].any()


def _proposals(imdb):
    rng = np.random.RandomState(0)
    return [jlabels.perturb_gt_regions(e["boxes"], (e["height"], e["width"]), 8, rng)
            for e in imdb.roidb[:imdb.num_images]]


@pytest.mark.parametrize("canvas", [True, False], ids=["prep_blob", "numpy_resize"])
def test_frcnn_minibatch_equal(canvas):
    j, t = _imdbs("synthetic_hard_val")
    props = _proposals(t)
    cv = tmb.fixed_canvas(t, TCFG) if canvas else None
    picks = [3, 6, 9, 10]
    assert any(t.roidb[i]["difficult"].any() for i in picks)
    for a, b in ((0, 2), (2, 4)):
        args = ([props[i] for i in picks[a:b]],)
        want = jmb.get_frcnn_minibatch(j, [j.roidb[i] for i in picks[a:b]], *args, JCFG,
                                       np.random.RandomState(a), cv)
        got = tmb.get_frcnn_minibatch(t, [t.roidb[i] for i in picks[a:b]], *args, TCFG,
                                      np.random.RandomState(a), cv)
        _assert_equal_trees(want, got)
        assert (got["labels"] > 0).any() and got["bbox_inside"].any()


# -- the multi-process stream ---------------------------------------------------------


def _spec(cfg, **extra):
    return {"imdb_name": "synthetic_train", "cfg": cfg, "seed": 7, "pid": 0, "pcount": 1,
            "ims_local": 2, **extra}


def _stream(builder, args, n, start=0, workers=2):
    pf = tprefetch.MPPrefetcher(builder, args, workers=workers, start=start)
    try:
        got = [pf.next() for _ in range(n)]
    finally:
        pf.close()
    assert not any(p.is_alive() for p in pf._procs)
    return got, pf.worker_env


def test_mp_stream_equals_the_jax_builder_and_workers_stay_off_the_card():
    """Two workers give the JAX builder's batches at the same indices, from
    index 0 and from a resume index; no worker imported jax or initialised
    CUDA, and each saw the card hidden."""
    serial = jprefetch.az_batch_builder(_spec(JCFG))
    want = [serial(t) for t in range(5)]
    got, env = _stream(tprefetch.az_batch_builder, _spec(TCFG), 4)
    _assert_equal_trees(want[:4], got)
    assert sorted(env) == [0, 1]
    for e in env.values():
        assert (e["jax_imported"], e["cuda_initialized"], e["cuda_visible_devices"]) == (
            False, False, ""), env
        assert e["batch_s"] > 0
    assert "jax" in sys.modules  # this process has JAX: the workers did not inherit it
    got, _ = _stream(tprefetch.az_batch_builder, _spec(TCFG), 2, start=3, workers=3)
    _assert_equal_trees(want[3:5], got)


def test_mp_frcnn_stream_equals_the_jax_builder(tmp_path):
    j = jimdb.get_imdb("synthetic_train")
    pkl = tmp_path / "props.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(_proposals(j), f)
    serial = jprefetch.frcnn_batch_builder(_spec(JCFG, proposals_path=str(pkl)))
    got, _ = _stream(tprefetch.frcnn_batch_builder, _spec(TCFG, proposals_path=str(pkl)), 2)
    _assert_equal_trees([serial(t) for t in range(2)], got)


def test_rng_for_batch_equal_and_worker_errors_reach_the_parent():
    """A worker's exception, or its death, raises in the parent."""
    for t in (0, 3, 1 << 20):
        assert (jprefetch.rng_for_batch(7, t).randint(1 << 30, size=4).tolist()
                == tprefetch.rng_for_batch(7, t).randint(1 << 30, size=4).tolist())
    pf = tprefetch.MPPrefetcher(tprefetch.az_batch_builder, _spec(TCFG, imdb_name="nope"), 1)
    try:
        with pytest.raises(RuntimeError, match="unknown imdb"):
            pf.next()
    finally:
        pf.close()
    pf = tprefetch.MPPrefetcher(os._exit, 3, 1)  # a worker that dies without a word
    try:
        with pytest.raises(RuntimeError, match=r"exited: \[\(0, 3\)\]"):
            pf.next()
    finally:
        pf.close()
    assert jax.devices()[0].platform == "cpu"
