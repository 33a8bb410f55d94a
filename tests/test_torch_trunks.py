"""Port parity, the small trunks: CaffeNet and VGG_CNN_M_1024 (``lrn``,
``_pool3x2``, the SAME-padding rule, the trunks, their weight conversion and
the propose path on them), each against the JAX package on the same NumPy
inputs (weights through ``params_from_flax``); and, for all three new
backbones (ResNet-50 too, see ``test_torch_resnet.py``), the config files
and the build and int8 guards.

Tolerances:
- ``lrn``: rtol 1e-5 in float32 (sums in another order); in bf16, one bf16
  rounding of that (8e-3).
- ``_pool3x2``, ``pad_same``, the config files: exact.
- Grouped and 1x1 kernels converted: 1e-5 (convolutions sum in another
  order).
- Float32 trunks at 64x96 and 70x90: 1e-4 of the output's max |x|.
- ``make_propose_batch``: scores 1e-5, boxes 2e-3 px (``test_torch_api.py``),
  the valid flags exactly.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from aznet_tpu import api as japi
from aznet_tpu import config as jconfig
from aznet_tpu.models import small as jsmall
from aznet_tpu_torch import api as tapi
from aznet_tpu_torch import config as tconfig
from aznet_tpu_torch.models import aznet as taznet
from aznet_tpu_torch.models import small as tsmall
from aznet_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 96)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _load(module, params):
    module.load_state_dict(params_from_flax(_np_tree(params)))
    return module.eval()


def _assert_rel(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# -- the pieces ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_lrn_matches(dtype):
    x = np.random.RandomState(0).randn(2, 5, 6, 37).astype(np.float32) * 30
    want = jsmall.lrn(jnp.asarray(x) if dtype is np.float32
                      else jnp.asarray(x).astype(jnp.bfloat16))
    tx = torch.from_numpy(x) if dtype is np.float32 else torch.from_numpy(x).to(torch.bfloat16)
    got = tsmall.lrn(tx)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-5 if dtype is np.float32 else 8e-3, atol=0)
    # the trunks call it on NCHW along dim 1
    nchw = tsmall.lrn(tx.permute(0, 3, 1, 2), dim=1).permute(0, 2, 3, 1)
    assert torch.equal(nchw, got)


@pytest.mark.parametrize("h", [7, 8, 9, 10])
def test_pool3x2_matches(h):
    x = np.random.RandomState(h).randn(2, h, h + 3, 4).astype(np.float32)
    want = np.asarray(jsmall._pool3x2(jnp.asarray(x)))
    got = tsmall._pool3x2(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert want.shape[1] == -(-(h - 3) // 2) + 1  # Caffe's ceil mode
    np.testing.assert_array_equal(got.numpy(), want)


# Every strided SAME conv of the three trunks: (kernel, stride).
STRIDED = [("caffenet.conv1", 11, 4), ("vgg_cnn_m.conv1", 7, 2), ("vgg_cnn_m.conv2", 5, 2),
           ("resnet50.block_conv2", 3, 2)]


@pytest.mark.parametrize("name,k,s", STRIDED)
def test_pad_same_is_xlas(name, k, s):
    """``pad_same`` places XLA's SAME padding (asymmetric at a stride) for
    the sizes the trunks meet: 608, 800, 1088, 1920 and odd sizes."""
    for n in (608, 800, 1088, 1920, 375, 61, 17):
        (lo_h, hi_h), (lo_w, hi_w) = jax.lax.padtype_to_pads((n, n + 1), (k, k), (s, s), "SAME")
        x = torch.arange(1, n * (n + 1) + 1, dtype=torch.float32).reshape(1, 1, n, n + 1)
        want = np.pad(x.numpy(), ((0, 0), (0, 0), (lo_h, hi_h), (lo_w, hi_w)))
        np.testing.assert_array_equal(tsmall.pad_same(x, k, s).numpy(), want, err_msg=name)


def test_grouped_and_1x1_kernels_convert():
    """HWIO -> OIHW holds for grouped ([kh, kw, C/g, Co]) and 1x1 kernels:
    the converted weight convolves as the Flax kernel does."""
    import flax.linen as nn

    rng = np.random.RandomState(3)
    x = rng.randn(1, 9, 11, 8).astype(np.float32)
    for feat, groups, ksz in ((12, 2, 3), (16, 1, 1), (8, 4, 5)):
        jm = nn.Conv(feat, (ksz, ksz), padding="SAME", feature_group_count=groups, use_bias=False)
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = np.asarray(jm.apply(params, jnp.asarray(x)))
        w = params_from_flax(_np_tree(params))["weight"]
        assert w.shape == (feat, 8 // groups, ksz, ksz)
        got = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), w, padding=ksz // 2,
                       groups=groups).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# -- the float trunks -----------------------------------------------------------


@pytest.mark.parametrize("jcls,tcls,hw", [
    (jsmall.CaffeNetTrunk, tsmall.CaffeNetTrunk, HW),
    (jsmall.CaffeNetTrunk, tsmall.CaffeNetTrunk, (70, 90)),
    (jsmall.VGGCNNM1024Trunk, tsmall.VGGCNNM1024Trunk, HW),
    (jsmall.VGGCNNM1024Trunk, tsmall.VGGCNNM1024Trunk, (70, 90)),
])
def test_small_trunks_match_f32(jcls, tcls, hw):
    x = np.random.RandomState(1).uniform(-100, 100, (2,) + hw + (3,)).astype(np.float32)
    jm = jcls(dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = _load(tcls(), params)(torch.from_numpy(x))
    assert got.shape[-1] == tcls.out_channels
    _assert_rel(got, want, 1e-4)


SMALL_NETS = {
    "caffenet": {"POOL_SIZE": 6},
    "vgg_cnn_m_1024": {"POOL_SIZE": 6, "FC7_DIM": 48},
}


@functools.lru_cache(maxsize=None)
def _nets(backbone):
    """The JAX AZ net (f32, FC_DIM 64, two search levels) and the port's on
    its converted weights, with their configs."""
    over = {"MODEL": {"BACKBONE": backbone, "FC_DIM": 64, "NUM_TEMPLATES": 5,
                      "COMPUTE_DTYPE": "float32", **SMALL_NETS[backbone]},
            "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 2, "NUM_PROPOSALS": 10},
            "TEST": {"SCALES": [64], "MAX_SIZE": 128}}
    jcfg = jconfig.cfg_from_dict(jconfig.Config(), over)
    tcfg = tconfig.cfg_from_dict(tconfig.Config(), over)
    jnet = japi.build_az_net(jcfg)
    tnet = tapi.build_az_net(tcfg, state_dict=params_from_flax(_np_tree(jnet.params)),
                             device="cpu")
    return jnet, tnet, jcfg, tcfg


@pytest.mark.parametrize("backbone", sorted(SMALL_NETS))
def test_params_from_flax_trees(backbone):
    """The converted JAX tree names every port parameter, with its shape
    (the grouped convs' kernels included)."""
    jnet, tnet, _, _ = _nets(backbone)
    sd = params_from_flax(_np_tree(jnet.params))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in tnet.model.state_dict().items()}
    if backbone == "caffenet":
        assert sd["trunk.conv4.weight"].shape == (384, 192, 3, 3)


@pytest.mark.parametrize("backbone", sorted(SMALL_NETS))
def test_make_propose_batch_matches(backbone):
    jnet, tnet, jcfg, tcfg = _nets(backbone)
    ims = np.random.RandomState(5).randint(0, 256, (2, 96, 128, 3)).astype(np.uint8)
    want = jax.jit(japi.make_propose_batch(jnet.model, jcfg, (64, 128)))(
        jnet.params, jnp.asarray(ims))
    got = tapi.make_propose_batch(tnet.model, tcfg, (64, 128))(torch.from_numpy(ims))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-3, rtol=0)


# -- configs and guards -----------------------------------------------------------


@pytest.mark.parametrize("name", ["resnet50_1080p", "az_caffenet_voc", "az_vgg_cnn_m_1024_voc"])
def test_cfg_files_equal(name):
    path = os.path.join(REPO, "experiments", "cfgs", f"{name}.yml")
    want = jconfig.cfg_to_dict(jconfig.cfg_from_file(jconfig.Config(), path))
    got = tconfig.cfg_to_dict(tconfig.cfg_from_file(tconfig.Config(), path))
    assert got == want


@pytest.mark.parametrize("backbone", ["resnet50", "caffenet", "vgg_cnn_m_1024"])
def test_build_on_card_by_default(backbone, monkeypatch):
    """Without a card the default device raises; ``device="cpu"`` builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.cfg_from_dict(tconfig.Config(), {"MODEL": {
        "BACKBONE": backbone, "FC_DIM": 16, "POOL_SIZE": 6, "STEM_S2D": False}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.build_az_net(cfg)
    net = tapi.build_az_net(cfg, device="cpu")
    assert net.device.type == "cpu"
    assert type(net.model.trunk).__name__ == {
        "resnet50": "ResNet50Trunk", "caffenet": "CaffeNetTrunk",
        "vgg_cnn_m_1024": "VGGCNNM1024Trunk"}[backbone]


def test_stem_s2d_is_ignored_with_a_warning():
    with pytest.warns(UserWarning, match="STEM_S2D"):
        taznet.AZNet(tconfig.ModelConfig(BACKBONE="resnet50", FC_DIM=16, STEM_S2D=True))


@pytest.mark.parametrize("backbone", ["caffenet", "vgg_cnn_m_1024"])
def test_int8_on_small_trunks_raises(backbone):
    mc = tconfig.ModelConfig(BACKBONE=backbone, FC_DIM=16, COMPUTE_DTYPE="int8")
    with pytest.raises(ValueError, match="vgg16 and resnet50"):
        taznet.AZNet(mc)
    with pytest.raises(ValueError, match="vgg16 and resnet50"):
        japi.build_az_net(jconfig.Config(MODEL=jconfig.ModelConfig(**dataclasses.asdict(mc))))

