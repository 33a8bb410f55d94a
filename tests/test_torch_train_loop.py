"""Port parity and contracts, the training loops: one hard-region mining
harvest against the JAX package's on the same weights, and ``train_az_net``
/ ``train_frcnn_net`` on the CPU (smallnet, 96-pixel synthetic images):
snapshots, the ``deploy/`` copy, auto-resume, the worker stream.

Tolerances: the harvest's regions to 1e-3 px in original coordinates and
the same count per image (the search tests' bounds; both packages search
the same weights from the same blobs); a resumed run equals an
uninterrupted one bit for bit (``NUM_WORKERS`` 2: batch ``t`` is a function
of ``(seed, t)``, and so are the dropout masks of step ``t``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aznet_tpu.config import Config as JConfig
from aznet_tpu.config import cfg_from_dict as jcfg_from_dict
from aznet_tpu.data.synthetic import SyntheticImdb as JSyntheticImdb
from aznet_tpu.models import AZNet as JAZNet
from aznet_tpu.train.mining import RegionMiner as JRegionMiner
from aznet_tpu_torch.config import Config, cfg_from_dict
from aznet_tpu_torch.data.imdb import get_imdb
from aznet_tpu_torch.data.synthetic import SyntheticImdb
from aznet_tpu_torch.train import loop as tloop
from aznet_tpu_torch.train.mining import RegionMiner
from aznet_tpu_torch.train.train_az import make_az_train_state
from aznet_tpu_torch.utils.checkpoint import Checkpointer, bake_bbox_normalization
from aznet_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(2)

MINE = {
    "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 32, "NUM_TEMPLATES": 5,
              "COMPUTE_DTYPE": "float32"},
    "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 3, "NUM_PROPOSALS": 10,
             "ZOOM_THRESH": 0.1},
    "TRAIN": {"SCALES": (64,), "MAX_SIZE": 96, "MINE_INTERVAL": 1, "MINE_IMAGES": 4},
}
LOOP = cfg_from_dict(Config(), {
    "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 32, "NUM_TEMPLATES": 11, "NUM_CLASSES": 4,
              "COMPUTE_DTYPE": "float32", "DROPOUT": 0.5},
    "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 3, "NUM_PROPOSALS": 20},
    "TRAIN": {"SCALES": [96], "MAX_SIZE": 128, "REGIONS_PER_IMAGE": 32, "IMS_PER_BATCH": 2,
              "BATCH_SIZE": 32, "USE_FLIPPED": True, "SNAPSHOT_ITERS": 10000,
              "LEARNING_RATE": 0.01},
    "TEST": {"SCALES": [96], "MAX_SIZE": 128},
})


def _with(cfg, **train):
    return dataclasses.replace(cfg, TRAIN=dataclasses.replace(cfg.TRAIN, **train))


def test_region_miner_harvest_matches_jax():
    """The JAX package's mining setup (``tests/test_search.py``): smallnet at
    ZOOM_THRESH 0.1, 4 synthetic images in batches of 2, one harvest each
    with the same weights."""
    jcfg, tcfg = jcfg_from_dict(JConfig(), MINE), cfg_from_dict(Config(), MINE)
    jmodel = JAZNet(model_cfg=jcfg.MODEL)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         jnp.array([[0.0, 0.0, 31.0, 31.0]]))
    jminer = JRegionMiner(jmodel, jcfg, JSyntheticImdb(num_images=4), list(range(4)),
                          batch_size=2)
    assert jminer.harvest(params) == 4
    state = make_az_train_state(tcfg, device="cpu",
                                state_dict=params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                                   params)))
    miner = RegionMiner(tcfg, SyntheticImdb(num_images=4), list(range(4)), batch_size=2)
    assert miner.harvest(state.model) == 4
    assert sorted(miner.cache) == sorted(jminer.cache) == [0, 1, 2, 3]
    n = 0
    for i, want in jminer.cache.items():
        got = miner.mined_for(i)
        assert got.dtype == np.float32 and got.shape == want.shape, (i, got.shape, want.shape)
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
        n += len(got)
    assert n > 0
    # The harvest used an inference copy: the training net is untouched.
    assert all(p.dtype == torch.float32 and p.requires_grad for p in state.model.parameters())


def _final(state):
    snap = state.snapshot()
    return snap["params"], snap["opt_state"]["momentum"], snap["step"]


def test_train_az_net_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    """4 steps in one run equal 2 steps, then a resumed run to 4, bit for bit
    (two prefetch workers, dropout on)."""
    cfg = _with(LOOP, NUM_WORKERS=2)
    full, _, out = tloop.train_az_net(cfg, "synthetic_train", max_iters=4,
                                      output_dir=str(tmp_path / "full"), device="cpu")
    assert Checkpointer(out).all_steps() == [4]
    part, _, out = tloop.train_az_net(cfg, "synthetic_train", max_iters=2,
                                      output_dir=str(tmp_path / "part"), device="cpu")
    assert part.step == 2
    resumed, _, _ = tloop.train_az_net(cfg, "synthetic_train", max_iters=4,
                                       output_dir=out, device="cpu")
    assert "[az] resumed from step 2" in capsys.readouterr().out
    assert resumed.step == 4 and Checkpointer(out).all_steps() == [2, 4]
    for a, b in zip(_final(full)[:2], _final(resumed)[:2]):
        assert sorted(a) == sorted(b)
        for k in a:
            torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=k)
    assert not torch.equal(part.model.state_dict()["head.fc.fc6.weight"],
                           resumed.model.state_dict()["head.fc.fc6.weight"])


def test_train_az_net_with_mining_writes_snapshots_and_deploy(tmp_path, capsys):
    """The prefetch thread with hard-region mining every 2 steps (workers
    are refused with mining), the last snapshot, and the deploy copy with
    the normalization baked in."""
    cfg = _with(LOOP, MINE_INTERVAL=2, MINE_IMAGES=4, NUM_WORKERS=2)
    state, model, out = tloop.train_az_net(cfg, "synthetic_train", max_iters=3,
                                           output_dir=str(tmp_path), device="cpu")
    printed = capsys.readouterr().out
    assert "NUM_WORKERS ignored" in printed
    assert printed.count("mined search regions for 4 images") == 2
    assert "[az 3] loss=" in printed
    assert state.step == 3 and model is state.model
    deploy, step = Checkpointer(os.path.join(out, "deploy")).restore({"params": 0})
    want = bake_bbox_normalization(model.state_dict(), cfg.TRAIN.BBOX_NORMALIZE_MEANS,
                                   cfg.TRAIN.BBOX_NORMALIZE_STDS, head_name="adj_bbox")
    assert step == 3 and sorted(deploy["params"]) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(deploy["params"][k], v, rtol=0, atol=0)


def test_train_frcnn_net_runs_with_a_proposals_fn(tmp_path, capsys):
    imdb = get_imdb("synthetic_train")
    props = lambda i: imdb.roidb[i % imdb.num_images]["boxes"] + 2.0  # noqa: E731
    state, model, out = tloop.train_frcnn_net(_with(LOOP, NUM_WORKERS=2), "synthetic_train",
                                              props, max_iters=2, output_dir=str(tmp_path),
                                              device="cpu")
    printed = capsys.readouterr().out
    assert "NUM_WORKERS ignored" in printed and "[frcnn 2] loss=" in printed
    assert state.step == 2
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert Checkpointer(out).all_steps() == [2]
    assert Checkpointer(os.path.join(out, "deploy")).all_steps() == [2]


def test_local_indices_and_batch_size():
    assert tloop.process_local_indices(5) == [0, 1, 2, 3, 4]
    assert tloop.process_local_indices(5, 1, 2) == [1, 3]
    assert tloop.process_local_indices(1, 3, 4) == [0]
    assert tloop.local_batch_size(8, 4) == 2
    with pytest.raises(ValueError, match="divisible"):
        tloop.local_batch_size(3, 2)
