"""Port parity, API: ``im_propose`` and ``make_propose_batch(_padded)`` on
the ``tests/test_api.py`` config (smallnet, f32) with the JAX net's weights.

Tolerances: scores 1e-5 (sigmoid probabilities), boxes 2e-3 in original
pixels (1e-3 in the scaled image, divided by the 0.64 scale); the number
of proposals and their order exactly.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aznet_tpu import api as japi
from aznet_tpu.config import Config, cfg_from_dict
from aznet_tpu_torch import api as tapi
from aznet_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CFG = cfg_from_dict(
    Config(),
    {
        "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 32, "NUM_TEMPLATES": 5,
                  "NUM_CLASSES": 4, "COMPUTE_DTYPE": "float32"},
        "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 2,
                 "NUM_PROPOSALS": 10},
        "TEST": {"SCALES": [64], "MAX_SIZE": 128},
    },
)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nets(cfg):
    jnet = japi.build_az_net(cfg)
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, jnet.params))
    return jnet, tapi.build_az_net(cfg, state_dict=sd)


def _assert_props(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got[..., 4], want[..., 4], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[..., :4], want[..., :4], atol=2e-3, rtol=0)


@pytest.mark.parametrize("scales", [(64,), (48, 64)])
def test_im_propose_matches(scales):
    cfg = dataclasses.replace(CFG, TEST=dataclasses.replace(CFG.TEST, SCALES=scales))
    jnet, tnet = _nets(cfg)
    for seed, hw in ((0, (100, 150)), (2, (90, 140))):
        im = np.random.RandomState(seed).randint(0, 256, hw + (3,)).astype(np.uint8)
        got = tapi.im_propose(tnet, im)
        assert got.dtype == np.float32 and 0 < got.shape[0] <= 10
        _assert_props(got, japi.im_propose(jnet, im))


def test_make_propose_batch_matches():
    jnet, tnet = _nets(CFG)
    ims = np.random.RandomState(5).randint(0, 256, (2, 96, 128, 3)).astype(np.uint8)
    want = jax.jit(japi.make_propose_batch(jnet.model, CFG, (64, 128)))(
        jnet.params, jnp.asarray(ims))
    got = tapi.make_propose_batch(tnet.model, CFG, (64, 128))(torch.from_numpy(ims))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _assert_props(torch.cat([got[0], got[1][..., None]], -1),
                  np.concatenate([np.asarray(want[0]), np.asarray(want[1])[..., None]], -1))


def test_make_propose_batch_padded_matches():
    jnet, tnet = _nets(CFG)
    rng = np.random.RandomState(6)
    raw = np.zeros((2, 100, 160, 3), np.uint8)
    hws = [(100, 150), (80, 120)]
    for i, (h, w) in enumerate(hws):
        raw[i, :h, :w] = rng.randint(0, 256, (h, w, 3))
    src_hw = np.asarray(hws, np.float32)
    scales = np.asarray([tapi.compute_scale(h, w, 64, 128) for h, w in hws], np.float32)
    want = jax.jit(japi.make_propose_batch_padded(jnet.model, CFG, (64, 128)))(
        jnet.params, jnp.asarray(raw), jnp.asarray(src_hw), jnp.asarray(scales))
    got = tapi.make_propose_batch_padded(tnet.model, CFG, (64, 128))(
        torch.from_numpy(raw), torch.from_numpy(src_hw), torch.from_numpy(scales))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _assert_props(torch.cat([got[0], got[1][..., None]], -1),
                  np.concatenate([np.asarray(want[0]), np.asarray(want[1])[..., None]], -1))


def test_port_runs_without_jax():
    """The card's machine has no JAX: import the port with ``jax`` and
    ``flax`` made unimportable, build a smallnet net with the port's own
    seeded init on the CPU, and propose."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax"):
            sys.modules[name] = None
        import numpy as np, torch
        torch.set_num_threads(1)
        from aznet_tpu.config import Config, cfg_from_dict
        from aznet_tpu_torch.api import build_az_net, im_propose
        cfg = cfg_from_dict(Config(), {
            "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 32, "NUM_TEMPLATES": 5},
            "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 2,
                     "NUM_PROPOSALS": 10},
            "TEST": {"SCALES": [64], "MAX_SIZE": 128}})
        im = np.random.RandomState(0).randint(0, 256, (100, 150, 3)).astype(np.uint8)
        dets = im_propose(build_az_net(cfg, device="cpu"), im)
        assert dets.shape[1] == 5 and 0 < dets.shape[0] <= 10, dets.shape
        assert np.isfinite(dets).all()
        assert not any(m.split(".")[0] in ("jax", "flax") for m in sys.modules
                       if sys.modules[m] is not None)
        print("OK", dets.shape[0])
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK")
