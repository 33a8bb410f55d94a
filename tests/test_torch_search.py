"""Port parity, search: frontier schedule, seeds and the whole zoom search
against the JAX ``az_search``, with one smallnet head (the
``tests/test_search.py`` setup) converted by ``params_from_flax``.

Both searches read the SAME trunk features (the JAX ones), so the search is
held alone. Tolerances: boxes 1e-3 absolute (pixels), scores 1e-5 (sigmoid
probabilities), valid masks exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aznet_tpu.config import ModelConfig, SearchConfig
from aznet_tpu.models import AZNet as JAZNet
from aznet_tpu.search import propose as jprop
from aznet_tpu_torch.models.aznet import AZNet
from aznet_tpu_torch.search import propose as tprop
from aznet_tpu_torch.utils.convert import params_from_flax

import _search_level_cases as cases

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SMALL = ModelConfig(BACKBONE="smallnet", FC_DIM=32, NUM_TEMPLATES=5,
                    COMPUTE_DTYPE="float32", POOLING_MODE="align")
SCFG = SearchConfig(FRONTIER_CAP=32, CAND_BUF=256, MAX_LEVELS=3,
                    NUM_PROPOSALS=20, ZOOM_THRESH=0.2, MIN_SIZE=8.0,
                    CONF_THRESH=0.05, NMS_THRESH=0.7, SEED_LEVELS=1)
# Capacity binds at every level (6 seeds -> 30 children > 8 slots) and the
# candidates overflow CAND_BUF: eviction among the five equal-priority
# children of a parent and the CAND_BUF cap both depend on the tie order.
TIGHT = SearchConfig(FRONTIER_CAP=8, CAND_BUF=64, MAX_LEVELS=4,
                     NUM_PROPOSALS=15, ZOOM_THRESH=0.2, MIN_SIZE=4.0,
                     CONF_THRESH=0.05, NMS_THRESH=0.6, SEED_LEVELS=1)


@pytest.mark.parametrize("scfg", [
    SCFG, TIGHT, SearchConfig(), SearchConfig(SEED_LEVELS=2, FRONTIER_CAP=128, MAX_LEVELS=7),
])
def test_frontier_schedule_and_seeds_match(scfg):
    assert tprop.frontier_schedule(scfg) == jprop.frontier_schedule(scfg)
    assert tprop.seed_count(scfg.SEED_LEVELS) == jprop.seed_count(scfg.SEED_LEVELS)
    for h, w in ((100, 200), (600, 800)):
        for cap in (None, tprop.frontier_schedule(scfg)[0]):
            b_t, v_t = tprop.init_frontier(torch.tensor(float(h)), w, scfg, cap=cap)
            b_j, v_j = jprop.init_frontier(h, w, scfg, cap=cap)
            np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
            np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    with pytest.raises(ValueError):
        tprop.init_frontier(100, 100, SearchConfig(FRONTIER_CAP=4, SEED_LEVELS=1))


@pytest.fixture(scope="module")
def small_net():
    rng = np.random.RandomState(3)
    images = jnp.asarray(rng.uniform(-1, 1, (1, 96, 128, 3)).astype(np.float32))
    jm = JAZNet(model_cfg=SMALL)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), images, jnp.array([[0.0, 0.0, 63.0, 63.0]]))
    feat = jm.apply(params, images, method="features")[0]
    tm = AZNet(SMALL)
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, feat, tm.eval()


@pytest.mark.parametrize("scfg,hw", [(SCFG, (96, 128)), (TIGHT, (90, 120))])
def test_az_search_matches(small_net, scfg, hw):
    jm, params, feat, tm = small_net
    want = jax.jit(lambda f: jprop.az_search(
        lambda ff, r: jm.apply(params, ff, r, method="roi_forward"),
        f, hw, scfg, num_templates=5))(feat)
    with torch.no_grad():
        got = tprop.az_search(tm.roi_forward, torch.from_numpy(np.array(feat)),
                              (torch.tensor(float(hw[0])), torch.tensor(float(hw[1]))),
                              scfg, num_templates=5)
    b_j, s_j, v_j = (np.asarray(a) for a in want)
    b_t, s_t, v_t = (a.numpy() for a in got)
    np.testing.assert_array_equal(v_t, v_j)
    assert v_t.sum() > 5
    np.testing.assert_allclose(s_t, s_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(b_t, b_j, atol=1e-3, rtol=0)


def test_collect_frontier_is_not_ported(small_net):
    """``collect_frontier`` (ported with hard-region mining) against JAX's:
    the same proposals as without it, and the visited regions in the JAX
    layout (a FRONTIER_CAP block per level, the unrolled levels padded),
    boxes to 1e-3 px, validity exact; with SCFG (a level past the unrolled
    prefix) and TIGHT (every level at capacity)."""
    jm, params, feat, tm = small_net
    for scfg, hw in ((SCFG, (96, 128)), (TIGHT, (90, 120))):
        want = jax.jit(lambda f: jprop.az_search(
            lambda ff, r: jm.apply(params, ff, r, method="roi_forward"),
            f, hw, scfg, num_templates=5, collect_frontier=True))(feat)
        with torch.no_grad():
            got = tprop.az_search(tm.roi_forward, torch.from_numpy(np.array(feat)),
                                  (torch.tensor(float(hw[0])), torch.tensor(float(hw[1]))),
                                  scfg, num_templates=5, collect_frontier=True)
            plain = tprop.az_search(tm.roi_forward, torch.from_numpy(np.array(feat)),
                                    (torch.tensor(float(hw[0])), torch.tensor(float(hw[1]))),
                                    scfg, num_templates=5)
        assert len(got) == 5
        for a, b in zip(got[:3], plain):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        vis_j, ok_j = np.asarray(want[3]), np.asarray(want[4])
        vis_t, ok_t = got[3].numpy(), got[4].numpy()
        assert vis_t.shape == (scfg.MAX_LEVELS * scfg.FRONTIER_CAP, 4)
        np.testing.assert_array_equal(ok_t, ok_j)
        assert ok_t[scfg.FRONTIER_CAP:].sum() > 0
        np.testing.assert_allclose(vis_t, vis_j, atol=1e-3, rtol=0)


def _concat_levels(roi_forward, feat, hw, scfg, k):
    """The candidates as the search laid them out before the buffer: each
    unrolled level's ``level_step`` outputs, then a tail of ``rem *
    FRONTIER_CAP * K`` slots (zero boxes at NEG_INF where no level ran),
    joined by ``torch.cat``. Also each piece's length."""
    sched = tprop.frontier_schedule(scfg)
    r_cap = scfg.FRONTIER_CAP
    consts = tprop.level_consts(scfg, k, torch.tensor([float(hw[0]), float(hw[1])]))
    f_boxes, f_valid = tprop.init_frontier(consts.extent[0], consts.extent[1], scfg, cap=sched[0])
    cand_b, cand_s = [], []
    lvl = 0
    while lvl < scfg.MAX_LEVELS and sched[lvl] != r_cap:
        next_cap = sched[lvl + 1] if lvl + 1 < scfg.MAX_LEVELS else sched[lvl]
        b, s, f_boxes, f_valid = tprop.level_step(roi_forward(feat, f_boxes), f_boxes, f_valid,
                                                  next_cap, consts)
        cand_b.append(b)
        cand_s.append(s)
        lvl += 1
    rem = scfg.MAX_LEVELS - lvl
    if rem > 0:
        per_level = r_cap * k
        tail_b = torch.zeros((rem * per_level, 4))
        tail_s = torch.full((rem * per_level,), tprop.NEG_INF)
        for level in range(rem):
            if not bool(f_valid.any()):
                break
            b, s, f_boxes, f_valid = tprop.level_step(roi_forward(feat, f_boxes), f_boxes,
                                                      f_valid, r_cap, consts)
            tail_b[level * per_level:(level + 1) * per_level] = b
            tail_s[level * per_level:(level + 1) * per_level] = s
        cand_b += [tail_b[i * per_level:(i + 1) * per_level] for i in range(rem)]
        cand_s += [tail_s[i * per_level:(i + 1) * per_level] for i in range(rem)]
    return torch.cat(cand_b), torch.cat(cand_s), [len(s) for s in cand_s]


@pytest.mark.parametrize("config,min_size", [
    ("vgg16", None), ("resnet50_1080p", None), ("vgg16", 150.0), ("resnet50_1080p", 200.0)])
def test_candidate_buffer_matches_concatenated_levels(config, min_size):
    """The candidate buffer's offsets and length at both benchmark
    configurations' schedules, and its contents against ``torch.cat`` of the
    per-level outputs: every level run, and (a larger MIN_SIZE) a frontier
    that empties in the tail, whose slots stay zero at NEG_INF."""
    scfg, hw = cases.SEARCH_CONFIGS[config]
    if min_size is not None:
        scfg = dataclasses.replace(scfg, MIN_SIZE=min_size)
    head = cases.stand_in_head()
    feat = torch.zeros((4, 4, 8))
    want_b, want_s, lengths = _concat_levels(head, feat, hw, scfg, cases.K)
    starts, total = tprop.candidate_starts(scfg, cases.K)
    assert list(starts) == np.cumsum([0] + lengths[:-1]).tolist()
    assert total == sum(lengths) == want_s.shape[0]
    got_b, got_s = tprop.search_candidates(head, feat, hw, scfg, cases.K)
    torch.testing.assert_close(got_b, want_b, rtol=0, atol=0)
    torch.testing.assert_close(got_s, want_s, rtol=0, atol=0)
    ran = [bool((got_s[s:s + n] > tprop.NEG_INF).any()) for s, n in zip(starts, lengths)]
    assert all(ran) if min_size is None else (any(ran[2:]) and not ran[-1])


def _jax_level(out, f_boxes, f_valid, next_cap, hw, scfg, k, offset=1.0):
    """The JAX package's level after the head: the body of
    ``aznet_tpu/search/propose.py::az_search``'s nested ``level_step`` past
    its ``roi_forward`` call, on the JAX package's functions."""
    from aznet_tpu.ops.boxes import bbox_transform_inv, clip_boxes
    from aznet_tpu.search.templates import adjacency_templates, divide_regions, template_boxes

    zoom_p = jax.nn.sigmoid(out["zoom"])
    adj_p = jax.nn.sigmoid(out["adj_score"])
    anchors = template_boxes(f_boxes, adjacency_templates(k), offset)
    boxes = bbox_transform_inv(anchors, out["adj_delta"], offset, clip=scfg.BBOX_XFORM_CLIP)
    boxes = clip_boxes(boxes, (jnp.float32(hw[0]), jnp.float32(hw[1])), offset)
    scores = jnp.where(f_valid[:, None], adj_p, jprop.NEG_INF)
    children = divide_regions(f_boxes, scfg.DIV_OVERLAP, offset)
    cw = children[..., 2] - children[..., 0] + offset
    ch = children[..., 3] - children[..., 1] + offset
    parent_ok = f_valid & (zoom_p > scfg.ZOOM_THRESH)
    child_ok = parent_ok[:, None] & (jnp.minimum(cw, ch) >= scfg.MIN_SIZE)
    priority = jnp.where(child_ok, zoom_p[:, None], jprop.NEG_INF).reshape(-1)
    cboxes = children.reshape(-1, 4)
    if next_cap > priority.shape[0]:
        pad = next_cap - priority.shape[0]
        priority = jnp.pad(priority, (0, pad), constant_values=jprop.NEG_INF)
        cboxes = jnp.pad(cboxes, ((0, pad), (0, 0)))
    top_p, top_i = jax.lax.top_k(priority, next_cap)
    return boxes.reshape(-1, 4), scores.reshape(-1), cboxes[top_i], top_p > jprop.NEG_INF


@pytest.mark.parametrize("case", cases.CASES)
@pytest.mark.parametrize("r", [8, 64])
def test_level_step_matches_jax_level(case, r):
    """The plain ``level_step`` on the edge cases the kernel's card tests
    cover, against the JAX package's level: boxes to 1e-3 px, scores to 1e-5,
    the next frontier's boxes to 1e-3 px and its validity exactly (the ties
    between a parent's children and, in ``cross_parent_ties``, across
    parents fall to the lower index in both)."""
    scfg, hw = cases.SEARCH_CONFIGS["vgg16"]
    out, f_boxes, f_valid, next_cap, consts = cases.level_case(case, r, 3 + r, "cpu", im_hw=hw,
                                                             scfg=scfg)
    got = [t.numpy() for t in tprop.level_step(out, f_boxes, f_valid, next_cap, consts)]
    want = [np.asarray(t) for t in _jax_level(
        {name: jnp.asarray(v.numpy()) for name, v in out.items()}, jnp.asarray(f_boxes.numpy()),
        jnp.asarray(f_valid.numpy()), next_cap, hw, scfg, cases.K)]
    np.testing.assert_allclose(got[0], want[0], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2], want[2], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3].shape == (next_cap,)
    assert got[3].any() == (case != "all_invalid")
