"""Port parity, evaluation: recall, VOC AP, COCO AP, the dataset drivers
(``eval/detection.py``) and ``calibrate_net_on_imdb``, each against the JAX
package on the same inputs.

- The metrics (``recall_table``, ``voc_ap``, ``eval_detections_on_roidb``,
  ``voc_eval``, ``coco_eval``) and ``_store_image_dets``: exact (``==``).
- The drivers: smallnet, float32, 4 classes, weights converted from the JAX
  nets (the Fast R-CNN net joined to the AZ net by ``share_trunk``), on
  ``SyntheticImdb(num_images=3)`` (192x256 images on a 64x128 canvas) at
  ``batch_size=2`` (so one tail batch). Proposals per image: the same count,
  scores to 1e-5, boxes to 2e-3 pixels (``tests/test_torch_api.py``'s
  bounds); refined boxes to 2e-3; detections: the same count per class and
  image, each port row within those bounds of a JAX row and back (near-tied
  scores may order two rows apart).
- The port's fused ``detect_all_batched`` against its two-program path: in
  float32 within the bounds above, with no row unmatched; in bf16 (VGG-16
  ``WIDTH`` 0.125, ``'align_pallas'``, ``FUSE_CONV1``; ``chip_smoke.py``
  phase 10 holds the full-width net to the same bound) scores to 1e-2,
  boxes to 1 px, at most 5% of either side's rows without a counterpart:
  the fused program pools at the search's boxes, the two-program path at
  the proposals divided by the scale and multiplied back, so bf16 features
  can round apart and move a detection across the per-image cap or an NMS
  decision.
- ``evaluate_recall`` / ``evaluate_detections``: exactly equal when the
  port's evaluation gets the JAX drivers' outputs; end to end, every recall
  and AP within one ground-truth match (1 / the number of gt boxes).
- ``calibrate_net_on_imdb`` (VGG-16 ``WIDTH`` 0.125, float32): the same
  ``INT8_SCALES`` / ``INT8_HEAD_SCALES`` to a relative 1e-5 (float32 convs
  sum in another order; ``tests/test_torch_int8.py``'s bound); the int8 net's
  ``propose_all`` at ``tests/test_torch_int8.py``'s int8 bound (the same
  count, sorted scores to 1e-4, 80% of the boxes within 0.5 px).
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aznet_tpu import api as japi
from aznet_tpu.config import Config as JConfig
from aznet_tpu.config import cfg_from_dict as jcfg_from_dict
from aznet_tpu.data.synthetic import SyntheticImdb as JSyntheticImdb
from aznet_tpu.eval import detection as jdet
from aznet_tpu.eval import recall as jrecall
from aznet_tpu.models.aznet import AZNet
from aznet_tpu.ops import quant as jquant
from aznet_tpu_torch import api as tapi
from aznet_tpu_torch.config import Config as TConfig
from aznet_tpu_torch.config import cfg_from_dict as tcfg_from_dict
from aznet_tpu_torch.data.synthetic import SyntheticImdb as TSyntheticImdb
from aznet_tpu_torch.eval import detection as tdet
from aznet_tpu_torch.eval import recall as trecall
from aznet_tpu_torch.ops import quant as tquant
from aznet_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

# The packages' ``__init__`` re-export functions named like these modules.
jcoco = importlib.import_module("aznet_tpu.eval.coco_eval")
tcoco = importlib.import_module("aznet_tpu_torch.eval.coco_eval")
jvoc = importlib.import_module("aznet_tpu.eval.voc_eval")
tvoc = importlib.import_module("aznet_tpu_torch.eval.voc_eval")

OVERRIDES = {
    "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 32, "NUM_TEMPLATES": 5, "NUM_CLASSES": 4,
              "COMPUTE_DTYPE": "float32"},
    "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 2, "NUM_PROPOSALS": 10},
    "TEST": {"SCALES": [64], "MAX_SIZE": 128},
}
S_TOL, B_TOL = 1e-5, 2e-3
FUSED_BOUNDS = {"float32": (S_TOL, B_TOL, 0.0), "bfloat16": (1e-2, 1.0, 0.05)}
N_IMAGES, BATCH = 3, 2


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# -- the metrics -------------------------------------------------------------


def _random_roidb(seed, n_img=4, n_classes=4, crowd=False):
    rng = np.random.RandomState(seed)
    roidb = []
    for _ in range(n_img):
        g = rng.randint(1, 6)
        xy = rng.uniform(0, 200, (g, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 120, (g, 2))], 1).astype(np.float32)
        entry = {"boxes": boxes, "gt_classes": rng.randint(1, n_classes, g).astype(np.int32),
                 "difficult": rng.rand(g) < 0.2}
        if crowd:
            entry["crowd"] = rng.rand(g) < 0.2
        roidb.append(entry)
    return roidb


def _random_dets(seed, roidb, n_classes=4):
    """Detections near the gt (jittered copies) and elsewhere, per class and
    image, with tied scores."""
    rng = np.random.RandomState(seed)
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in roidb] for _ in range(n_classes)]
    for c in range(1, n_classes):
        for i, e in enumerate(roidb):
            gt = e["boxes"][e["gt_classes"] == c]
            near = gt[rng.randint(0, len(gt), 3)] + rng.normal(0, 6, (3, 4)) if len(gt) else \
                np.zeros((0, 4))
            xy = rng.uniform(0, 250, (4, 2))
            far = np.concatenate([xy, xy + rng.uniform(5, 80, (4, 2))], 1)
            boxes = np.concatenate([near, far])
            scores = np.round(rng.rand(len(boxes), 1) * 8) / 8
            all_boxes[c][i] = np.concatenate([boxes, scores], 1).astype(np.float32)
    return all_boxes


def test_recall_table_equal():
    rng = np.random.RandomState(0)
    roidb = _random_roidb(1)
    gts = [e["boxes"] for e in roidb]
    props = []
    for g in gts:
        p = np.concatenate([g + rng.normal(0, 4, g.shape), rng.uniform(0, 300, (30, 4))])
        props.append(np.concatenate([p, rng.rand(len(p), 1)], 1).astype(np.float32))
    props[1] = props[1][:0]
    for kw in ({}, {"top_ks": (1, 3, 50), "iou_threshs": (0.3, 0.5, 0.95), "offset": 0.0}):
        assert trecall.recall_table(gts, props, **kw) == jrecall.recall_table(gts, props, **kw)
    assert trecall.proposal_recall(gts, props, 5, 0.6) == jrecall.proposal_recall(gts, props, 5, 0.6)


def test_voc_ap_equal():
    rng = np.random.RandomState(2)
    for n in (1, 7, 40):
        rec = np.sort(rng.rand(n))
        prec = rng.rand(n)
        for m07 in (True, False):
            assert tvoc.voc_ap(rec, prec, m07) == jvoc.voc_ap(rec, prec, m07)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_detections_on_roidb_equal(seed):
    roidb = _random_roidb(seed)
    all_boxes = _random_dets(seed + 10, roidb)
    for kw in ({}, {"ovthresh": 0.7, "use_07_metric": True}):
        got = tvoc.eval_detections_on_roidb(all_boxes, roidb, 4, **kw)
        assert got == jvoc.eval_detections_on_roidb(all_boxes, roidb, 4, **kw)
    assert 0 < got["mAP"] <= 1


def test_voc_eval_results_file_equal(tmp_path):
    roidb = _random_roidb(5)
    all_boxes = _random_dets(6, roidb)
    index = [f"{i:06d}" for i in range(len(roidb))]
    path = tmp_path / "det_test_cls.txt"
    with open(path, "w") as f:
        for i, idx in enumerate(index):
            for d in all_boxes[2][i]:
                f.write(f"{idx} {d[4]:.6f} {d[0] + 1:.1f} {d[1] + 1:.1f} {d[2] + 1:.1f} "
                        f"{d[3] + 1:.1f}\n")
    for m07 in (True, False):
        got = tvoc.voc_eval(str(path), roidb, index, 2, use_07_metric=m07)
        want = jvoc.voc_eval(str(path), roidb, index, 2, use_07_metric=m07)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        assert got[2] == want[2] and got[0].size


@pytest.mark.parametrize("seed", [0, 1])
def test_coco_eval_equal(seed):
    roidb = _random_roidb(seed + 20, n_img=5, crowd=True)
    all_boxes = _random_dets(seed + 30, roidb)
    for kw in ({}, {"max_dets": (1, 5, 20), "offset": 0.0}):
        got = tcoco.coco_eval(all_boxes, roidb, 4, **kw)
        want = jcoco.coco_eval(all_boxes, roidb, 4, **kw)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k
    assert got["AP50"] > 0


def test_store_image_dets_equal():
    """Per-class threshold, host NMS and the per-image cap (``>=`` at the
    cap's score, ties kept) on random float32 scores and boxes."""
    cfg = tcfg_from_dict(TConfig(), OVERRIDES)
    rng = np.random.RandomState(3)
    r, k = 60, 4
    scores = rng.dirichlet(np.ones(k), r).astype(np.float32)
    scores[:8, 1] = scores[8:16, 2] = 0.5  # ties at the cap
    xy = rng.uniform(0, 150, (r, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 60, (r, k, 2))], -1)
    boxes = boxes.reshape(r, 4 * k).astype(np.float32)
    for max_per_image in (100, 12, 5):
        got = [[None] for _ in range(k)]
        want = [[None] for _ in range(k)]
        tdet._store_image_dets(got, 0, scores, boxes, cfg, k, max_per_image)
        jdet._store_image_dets(want, 0, scores, boxes, cfg, k, max_per_image)
        for c in range(1, k):
            assert got[c][0].dtype == np.float32
            np.testing.assert_array_equal(got[c][0], want[c][0])
        assert sum(len(got[c][0]) for c in range(1, k)) >= min(max_per_image, 5)


def test_test_cfgs_compatible_equal():
    a = tcfg_from_dict(TConfig(), OVERRIDES)
    for test in ({"SCALES": (64,)}, {"SCALES": (48,)}, {"MAX_SIZE": 96}, {"SCALES": (48, 64)}):
        b = dataclasses.replace(a, TEST=dataclasses.replace(a.TEST, **test))
        assert tdet._test_cfgs_compatible(a, b) == jdet._test_cfgs_compatible(a, b)


# -- the drivers --------------------------------------------------------------


class Runs:
    """The JAX and port nets on one JAX init and each driver's outputs,
    computed once per module."""

    def __init__(self):
        jcfg = jcfg_from_dict(JConfig(), OVERRIDES)
        self.tcfg = tcfg_from_dict(TConfig(), OVERRIDES)
        self.jaz = japi.build_az_net(jcfg)
        tree = _np_tree(japi.build_frcnn_net(jcfg, rng=jax.random.PRNGKey(11)).params)
        self.jfr = japi.share_trunk(japi.build_frcnn_net(jcfg, params=tree), self.jaz)
        self.taz = tapi.build_az_net(self.tcfg, state_dict=params_from_flax(
            _np_tree(self.jaz.params)), device="cpu")
        self.tfr = tapi.share_trunk(tapi.build_frcnn_net(
            self.tcfg, state_dict=params_from_flax(tree), device="cpu"), self.taz)
        self.jimdb = JSyntheticImdb(split="test", seed=2, num_images=N_IMAGES)
        self.timdb = TSyntheticImdb(split="test", seed=2, num_images=N_IMAGES)

    @functools.cache
    def jax(self, name):
        return DRIVERS[name](jdet, self.jaz, self.jfr, self.jimdb, self)

    @functools.cache
    def port(self, name):
        return DRIVERS[name](tdet, self.taz, self.tfr, self.timdb, self)


DRIVERS = {
    "propose_all": lambda m, az, fr, imdb, r: m.propose_all(az, imdb),
    "propose_all_batched": lambda m, az, fr, imdb, r: m.propose_all_batched(
        az, imdb, batch_size=BATCH),
    # Both refine the JAX proposals: the same input.
    "refine": lambda m, az, fr, imdb, r: m.refine_proposals_batched(
        fr, imdb, r.jax("propose_all_batched"), batch_size=BATCH),
    "detect_all": lambda m, az, fr, imdb, r: m.detect_all(az, fr, imdb),
    "detect_fused": lambda m, az, fr, imdb, r: m.detect_all_batched(az, fr, imdb,
                                                                    batch_size=BATCH),
    "detect_two": lambda m, az, fr, imdb, r: m.detect_all_batched(az, fr, imdb,
                                                                  batch_size=BATCH, fused=False),
}


@pytest.fixture(scope="module")
def runs():
    return Runs()


def _assert_props(got, want):
    assert len(got) == len(want) == N_IMAGES
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape and g.shape[0] > 0, (g.shape, w.shape)
        np.testing.assert_allclose(g[:, 4], w[:, 4], atol=S_TOL, rtol=0)
        np.testing.assert_allclose(g[:, :4], w[:, :4], atol=B_TOL, rtol=0)


def _assert_all_boxes(got, want):
    assert len(got) == len(want) == OVERRIDES["MODEL"]["NUM_CLASSES"]
    total = 0
    for c in range(1, len(want)):
        assert len(got[c]) == len(want[c]) == N_IMAGES
        for g, w in zip(got[c], want[c]):
            assert g.dtype == np.float32 and g.shape == w.shape, (c, g.shape, w.shape)
            close = ((np.abs(g[:, None, :4] - w[None, :, :4]).max(-1) <= B_TOL)
                     & (np.abs(g[:, None, 4] - w[None, :, 4]) <= S_TOL))
            assert close.any(1).all() and close.any(0).all(), (c, g, w)
            total += len(g)
    assert total > 0


@pytest.mark.parametrize("name", ["propose_all", "propose_all_batched"])
def test_propose_drivers_match(runs, name):
    _assert_props(runs.port(name), runs.jax(name))


def test_propose_batched_equals_per_image(runs):
    """The padded batch (a tail batch included) gives each image's
    ``im_propose`` to the resize's reordered f32 sums."""
    for g, w in zip(runs.port("propose_all_batched"), runs.port("propose_all")):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


def test_refine_proposals_batched_matches(runs):
    got, want = runs.port("refine"), runs.jax("refine")
    props = runs.jax("propose_all_batched")
    for g, w, p in zip(got, want, props):
        assert g.shape == w.shape == p.shape
        np.testing.assert_array_equal(g[:, 4], p[:, 4])
        np.testing.assert_allclose(g[:, :4], w[:, :4], atol=B_TOL, rtol=0)
        assert not np.array_equal(g[:, :4], p[:, :4])


@pytest.mark.parametrize("name", ["detect_all", "detect_fused", "detect_two"])
def test_detect_drivers_match(runs, name):
    _assert_all_boxes(runs.port(name), runs.jax(name))


def _matched(a, b, s_tol, b_tol):
    """Rows of ``a [N, 5]`` with a row of ``b`` within the bounds."""
    if not (len(a) and len(b)):
        return np.zeros(len(a), bool)
    return ((np.abs(a[:, None, :4] - b[None, :, :4]).max(-1) <= b_tol)
            & (np.abs(a[:, None, 4] - b[None, :, 4]) <= s_tol)).any(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_agrees_with_two_program(runs, dtype):
    if dtype == "float32":
        fused, two = runs.port("detect_fused"), runs.port("detect_two")
    else:
        cfg = tcfg_from_dict(TConfig(), {
            "MODEL": {"WIDTH": 0.125, "FC_DIM": 32, "NUM_TEMPLATES": 5, "NUM_CLASSES": 4,
                      "POOLING_MODE": "align_pallas", "FUSE_CONV1": True},
            "SEAR": OVERRIDES["SEAR"], "TEST": OVERRIDES["TEST"]})
        az = tapi.build_az_net(cfg, device="cpu")
        fr = tapi.share_trunk(tapi.build_frcnn_net(cfg, device="cpu", seed=1), az)
        fused = tdet.detect_all_batched(az, fr, runs.timdb, batch_size=BATCH)
        two = tdet.detect_all_batched(az, fr, runs.timdb, batch_size=BATCH, fused=False)
    s_tol, b_tol, miss = FUSED_BOUNDS[dtype]
    unmatched = total = 0
    for c in range(1, 4):
        for a, b in zip(fused[c], two[c]):
            unmatched += (~_matched(a, b, s_tol, b_tol)).sum() + (~_matched(b, a, s_tol, b_tol)).sum()
            total += len(a) + len(b)
    assert total > 0 and unmatched <= miss * total, (unmatched, total)


def test_detect_all_batched_picks_fused(runs, monkeypatch):
    """``fused=None`` takes the fused program for shared trunks and the same
    TEST geometry, and the two-program path otherwise."""
    calls = []
    real = tdet.detect_all_fused
    monkeypatch.setattr(tdet, "detect_all_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _assert_all_boxes(tdet.detect_all_batched(runs.taz, runs.tfr, runs.timdb, batch_size=BATCH),
                      runs.jax("detect_fused"))
    assert calls == [1]
    other = dataclasses.replace(runs.tfr, cfg=dataclasses.replace(
        runs.tcfg, TEST=dataclasses.replace(runs.tcfg.TEST, MAX_SIZE=96)))
    tdet.detect_all_batched(runs.taz, other, runs.timdb, batch_size=BATCH, max_images=1)
    assert calls == [1]


def test_detect_all_fused_raises(runs):
    unshared = tapi.build_frcnn_net(runs.tcfg, state_dict=runs.tfr.params, device="cpu")
    jerr = {}
    for name, (jfr, tfr) in {
            "trunk": (japi.build_frcnn_net(runs.jaz.cfg), unshared),
            "geometry": (dataclasses.replace(runs.jfr, cfg=dataclasses.replace(
                runs.jfr.cfg, TEST=dataclasses.replace(runs.jfr.cfg.TEST, SCALES=(48,)))),
                dataclasses.replace(runs.tfr, cfg=dataclasses.replace(
                    runs.tcfg, TEST=dataclasses.replace(runs.tcfg.TEST, SCALES=(48,)))))}.items():
        with pytest.raises(ValueError) as want:
            jdet.detect_all_fused(runs.jaz, jfr, runs.jimdb)
        with pytest.raises(ValueError) as got:
            tdet.detect_all_fused(runs.taz, tfr, runs.timdb)
        assert str(got.value) == str(want.value)
        jerr[name] = str(got.value)
    assert "share_trunk" in jerr["trunk"] and "geometry" in jerr["geometry"]


def _n_gt(imdb):
    return sum(int((~e["difficult"]).sum()) for e in imdb.roidb[:N_IMAGES])


@pytest.mark.parametrize("batched,refine", [(False, False), (True, False), (True, True)])
def test_evaluate_recall(runs, monkeypatch, batched, refine):
    kw = dict(batched=batched, batch_size=BATCH, top_ks=(5, 10))
    want = jdet.evaluate_recall(runs.jaz, runs.jimdb, refine_net=runs.jfr if refine else None,
                                **kw)
    got = tdet.evaluate_recall(runs.taz, runs.timdb, refine_net=runs.tfr if refine else None,
                               **kw)
    bound = 1.0 / _n_gt(runs.timdb)  # one gt match, end to end
    for k in want:
        for t in want[k]:
            assert abs(got[k][t] - want[k][t]) <= bound, (k, t, got[k][t], want[k][t])
    # Given the JAX drivers' proposals, the port's evaluation is exact.
    props = runs.jax("propose_all_batched" if batched else "propose_all")
    monkeypatch.setattr(tdet, "propose_all", lambda *a, **k: props)
    monkeypatch.setattr(tdet, "propose_all_batched", lambda *a, **k: props)
    if refine:
        refined = runs.jax("refine")
        monkeypatch.setattr(tdet, "refine_proposals_batched", lambda *a, **k: refined)
    assert tdet.evaluate_recall(runs.taz, runs.timdb, refine_net=runs.tfr if refine else None,
                                **kw) == want
    assert tdet.evaluate_recall(runs.taz, runs.timdb, include_difficult=True, **kw) == \
        jdet.evaluate_recall(runs.jaz, runs.jimdb, include_difficult=True, **kw)


def test_evaluate_detections(runs, tmp_path):
    all_boxes = runs.jax("detect_fused")
    want = runs.jimdb.evaluate_detections(all_boxes, str(tmp_path))
    assert runs.timdb.evaluate_detections(all_boxes, str(tmp_path)) == want
    got = runs.timdb.evaluate_detections(runs.port("detect_fused"), str(tmp_path))
    for c in range(1, 4):
        npos = sum(int(((e["gt_classes"] == c) & ~e["difficult"]).sum())
                   for e in runs.timdb.roidb)
        assert abs(got[f"class_{c}"] - want[f"class_{c}"]) <= 1.0 / max(npos, 1)


def test_detect_all_cache_file(runs, tmp_path):
    import pickle

    path = str(tmp_path / "sub" / "detections.pkl")
    got = tdet.detect_all_batched(runs.taz, runs.tfr, runs.timdb, batch_size=BATCH,
                                  max_images=2, cache_file=path)
    with open(path, "rb") as f:
        cached = pickle.load(f)
    for c in range(1, 4):
        for g, w in zip(cached[c], got[c]):
            np.testing.assert_array_equal(g, w)


# -- calibration ----------------------------------------------------------------


def test_calibrate_net_on_imdb_matches(monkeypatch):
    monkeypatch.setenv("AZNET_INT8_INTERPRET", "1")
    over = {"MODEL": {"BACKBONE": "vgg16", "WIDTH": 0.125, "FC_DIM": 32, "NUM_TEMPLATES": 5,
                      "COMPUTE_DTYPE": "float32"},
            "SEAR": OVERRIDES["SEAR"], "TEST": OVERRIDES["TEST"]}
    jcfg = jcfg_from_dict(JConfig(), over)
    # ``build_az_net``'s own init, compiled: the eager init of VGG-16 takes ~20 s.
    init = jax.jit(AZNet(model_cfg=jcfg.MODEL).init)
    jnet = japi.build_az_net(jcfg, params=init(jax.random.PRNGKey(jcfg.RNG_SEED),
                                               jnp.zeros((1, 64, 64, 3), jnp.float32),
                                               jnp.array([[0.0, 0.0, 31.0, 31.0]])))
    tnet = tapi.build_az_net(tcfg_from_dict(TConfig(), over),
                             state_dict=params_from_flax(_np_tree(jnet.params)), device="cpu")
    jimdb = JSyntheticImdb(split="val", seed=1, num_images=N_IMAGES)
    timdb = TSyntheticImdb(split="val", seed=1, num_images=N_IMAGES)
    want = jquant.calibrate_net_on_imdb(jnet, jimdb, n_images=N_IMAGES)
    got = tquant.calibrate_net_on_imdb(tnet, timdb, n_images=N_IMAGES)
    assert got.device == tnet.device and isinstance(got.model, type(tnet.model))
    assert got.cfg.MODEL.COMPUTE_DTYPE == "int8" and len(got.cfg.MODEL.INT8_SCALES) == 13
    np.testing.assert_allclose(got.cfg.MODEL.INT8_SCALES, want.cfg.MODEL.INT8_SCALES,
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.cfg.MODEL.INT8_HEAD_SCALES, want.cfg.MODEL.INT8_HEAD_SCALES,
                               rtol=1e-5, atol=0)
    for k, v in tnet.params.items():  # rebuilt from the same float32 masters
        assert torch.equal(got.params[k], v), k
    for g, w in zip(tdet.propose_all(got, timdb), jdet.propose_all(want, jimdb)):
        assert g.shape == w.shape and g.shape[0] > 0
        np.testing.assert_allclose(np.sort(g[:, 4]), np.sort(w[:, 4]), atol=1e-4, rtol=0)
        near = np.abs(g[:, None, :4] - w[None, :, :4]).max(-1).min(-1) <= 0.5
        assert near.mean() >= 0.8, near
    fr = tquant.calibrate_net_on_imdb(tapi.build_frcnn_net(tnet.cfg, device="cpu"), timdb,
                                      n_images=2, int8_heads=False)
    assert type(fr.model).__name__ == "FRCNN" and fr.cfg.MODEL.INT8_HEAD_SCALES == ()
    small = tapi.build_az_net(tcfg_from_dict(TConfig(), OVERRIDES), device="cpu")
    with pytest.raises(ValueError, match="vgg16 trunk only"):
        tquant.calibrate_net_on_imdb(small, timdb)
