"""Port parity, search: frontier schedule, seeds and the whole zoom search
against the JAX ``az_search``, with one smallnet head (the
``tests/test_search.py`` setup) converted by ``params_from_flax``.

Both searches read the SAME trunk features (the JAX ones), so the search is
held alone. Tolerances: boxes 1e-3 absolute (pixels), scores 1e-5 (sigmoid
probabilities), valid masks exact.
"""

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
