"""Port parity, ResNet-50 (the ``resnet50`` backbone, float and int8): the
trunk, its weight conversion, the int8 1x1 convs, calibration and the
propose / detect API on it, each against the JAX package on the same NumPy
inputs (weights through ``params_from_flax``). Full depth (13 blocks) at
64x96.

Tolerances:
- Float32 trunk: 1e-4 of the output's max |x| (convolutions sum in another
  order), against JAX with its space-to-depth stem and without.
- bf16 trunk: 2e-2 of max |x| (the frameworks round bf16 at different
  places; see ``test_torch_models.py``).
- ``quantize_weights_1x1``, ``conv1x1_int8`` (integer grid and calibrated
  scales): bit-exact.
- ``calibrate_trunk_int8_resnet``: 1e-5 relative per scale.
- The int8 blocks, each fed JAX's block input (bf16): the block output
  quantized at the next block's input scale equals JAX's on at least 99% of
  the elements and differs by at most one code (bf16 roundings at other
  places move values across a quantization boundary); the whole int8 trunk
  to 5e-2 of max |x|.
- ``make_propose_batch``: scores 1e-5, boxes 2e-3 px (``test_torch_api.py``);
  ``im_detect``: scores 1e-5, boxes 2e-3 px.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aznet_tpu import api as japi
from aznet_tpu import config as jconfig
from aznet_tpu.models import resnet as jresnet
from aznet_tpu.ops import conv_int8 as jconv
from aznet_tpu.ops import quant as jquant
from aznet_tpu_torch import api as tapi
from aznet_tpu_torch import config as tconfig
from aznet_tpu_torch.models import aznet as taznet
from aznet_tpu_torch.models import resnet as tresnet
from aznet_tpu_torch.ops import conv_int8 as tconv
from aznet_tpu_torch.ops import quant as tquant
from aznet_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HW = (64, 96)
OVERRIDES = {
    "MODEL": {"BACKBONE": "resnet50", "FC_DIM": 64, "NUM_TEMPLATES": 5,
              "COMPUTE_DTYPE": "float32", "STEM_S2D": False},
    "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 2, "NUM_PROPOSALS": 10},
    "TEST": {"SCALES": [64], "MAX_SIZE": 128},
}


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _assert_rel(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _cfgs():
    return (jconfig.cfg_from_dict(jconfig.Config(), OVERRIDES),
            tconfig.cfg_from_dict(tconfig.Config(), OVERRIDES))


@pytest.fixture(scope="module")
def nets():
    """The JAX AZ net (f32, full-depth ResNet-50) and the port's, converted."""
    jcfg, tcfg = _cfgs()
    jnet = japi.build_az_net(jcfg)
    tnet = tapi.build_az_net(tcfg, state_dict=params_from_flax(_np_tree(jnet.params)),
                             device="cpu")
    return jnet, tnet


def _port_trunk(tnet, **kw):
    trunk = tresnet.ResNet50Trunk(**kw)
    trunk.load_state_dict({k[len("trunk."):]: v for k, v in tnet.params.items()
                           if k.startswith("trunk.")})
    return trunk.eval()


def _images(seed, n=1):
    return np.random.RandomState(seed).uniform(-100, 100, (n,) + HW + (3,)).astype(np.float32)


# -- float ----------------------------------------------------------------------


@pytest.mark.parametrize("s2d", [False, True])
def test_resnet50_trunk_matches_f32(nets, s2d):
    jnet, tnet = nets
    x = _images(5)
    want = jresnet.ResNet50Trunk(dtype=jnp.float32, stem_s2d=s2d).apply(
        {"params": jnet.params["params"]["trunk"]}, jnp.asarray(x))
    with torch.no_grad():
        got = tnet.model.features(torch.from_numpy(x))
    assert got.shape == (1, HW[0] // 16, HW[1] // 16, 1024)
    _assert_rel(got, want, 1e-4)


def test_resnet50_trunk_matches_bf16(nets):
    jnet, tnet = nets
    x = _images(6)
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                    {"params": jnet.params["params"]["trunk"]})
    want = jresnet.ResNet50Trunk(dtype=jnp.bfloat16).apply(params, jnp.asarray(x))
    tm = _port_trunk(tnet).to(torch.bfloat16)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    _assert_rel(got.float(), np.asarray(want, np.float32), 2e-2)


def test_params_from_flax_resnet_tree(nets):
    """Every port parameter (conv kernels, 1x1 kernels, FrozenBN ``scale``
    and ``bias``) comes from the JAX tree, with its shape."""
    jnet, tnet = nets
    sd = params_from_flax(_np_tree(jnet.params))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in tnet.model.state_dict().items()}
    assert sd["trunk.layer2_block0.downsample.weight"].shape == (512, 256, 1, 1)
    assert sd["trunk.layer3_block5.bn3.scale"].shape == (1024,)
    np.testing.assert_array_equal(
        sd["trunk.bn1.scale"].numpy(), np.asarray(jnet.params["params"]["trunk"]["bn1"]["scale"]))


# -- int8 -----------------------------------------------------------------------


def test_conv1x1_int8_exact_on_integer_grid():
    rng = np.random.RandomState(0)
    x = rng.randint(-127, 128, (2, 9, 11, 64)).astype(np.int8)
    w = rng.randint(-127, 128, (64, 32)).astype(np.int8)  # [C, Co], the reference's
    want = np.asarray(jconv.conv1x1_int8(jnp.asarray(x), 1.0, jnp.asarray(w),
                                         jnp.ones((32,), jnp.float32)))
    got = tconv.conv1x1_int8(torch.from_numpy(x), 1.0, torch.from_numpy(w.T.copy()),
                             torch.ones(32))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want.reshape(-1, 32),
                                  x.reshape(-1, 64).astype(np.int64) @ w.astype(np.int64))
    # calibrated, non power-of-two scales: the f32 epilogue as the reference's
    s_w = rng.uniform(1e-3, 1e-2, 32).astype(np.float32)
    want = np.asarray(jconv.conv1x1_int8(jnp.asarray(x), 0.0419, jnp.asarray(w),
                                         jnp.asarray(s_w), out_dtype=jnp.float32))
    got = tconv.conv1x1_int8(torch.from_numpy(x), 0.0419, torch.from_numpy(w.T.copy()),
                             torch.from_numpy(s_w))
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_weights_1x1_bit_equal():
    rng = np.random.RandomState(2)
    w = (rng.randn(1, 1, 48, 40) * 0.05).astype(np.float32)
    w[..., 5] = 0.0  # the 1e-12 floor
    jq, js = jconv.quantize_weights_1x1(jnp.asarray(w))
    tq, ts = tconv.quantize_weights_1x1(torch.from_numpy(w).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(tq.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_calibrate_trunk_int8_resnet_matches(nets):
    jnet, tnet = nets
    images = _images(7, 2)
    want = jquant.calibrate_trunk_int8_resnet(jnet, images, batch_size=1)
    got = tquant.calibrate_trunk_int8_resnet(tnet, images, batch_size=1)
    assert len(got) == len(want) == 2 * 13 + 1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_int8_resnet_blocks_match(nets):
    """Each int8 block fed JAX's block input (the module docstring's bound),
    then the whole int8 trunk."""
    jnet, tnet = nets
    images = _images(8)
    scales = jquant.calibrate_trunk_int8_resnet(jnet, images, batch_size=1)
    jm = jresnet.ResNet50Trunk(dtype=jnp.bfloat16, int8_mode=True, int8_scales=scales)
    feats, state = jm.apply({"params": jnet.params["params"]["trunk"]}, jnp.asarray(images),
                            capture_intermediates=True, mutable=["intermediates"])
    inter = state["intermediates"]
    trunk = _port_trunk(tnet, int8_mode=True, int8_scales=scales)
    trunk.prepare_int8()
    names = trunk.block_names
    outs = [np.asarray(inter[n]["__call__"][0], np.float32) for n in names]
    for i, name in enumerate(names[1:]):
        x = torch.from_numpy(outs[i]).to(torch.bfloat16).permute(0, 3, 1, 2)
        with torch.no_grad():
            got = getattr(trunk, name)(x, tuple(scales[2 * i + 2:2 * i + 4]))
        got = got.permute(0, 2, 3, 1).float()
        s_next = scales[2 * (i + 2)] if i + 2 < len(names) else scales[-1]
        qg = tconv.quantize_acts(got, s_next).numpy().astype(np.int32)
        qw = tconv.quantize_acts(torch.from_numpy(outs[i + 1]), s_next).numpy().astype(np.int32)
        d = np.abs(qg - qw)
        assert d.max() <= 1 and (d > 0).mean() <= 0.01, (name, d.max(), (d > 0).mean())
    with torch.no_grad():
        got = trunk(torch.from_numpy(images))
    _assert_rel(got.float(), np.asarray(feats, np.float32), 5e-2)


def test_int8_resnet_requires_scales():
    mc = tconfig.ModelConfig(BACKBONE="resnet50", FC_DIM=16, COMPUTE_DTYPE="int8",
                             STEM_S2D=False)
    with pytest.raises(ValueError, match="INT8_SCALES"):
        taznet.AZNet(mc).trunk(torch.zeros((1, 32, 32, 3)))


# -- the API --------------------------------------------------------------------


def test_make_propose_batch_matches_resnet50(nets):
    jnet, tnet = nets
    jcfg, tcfg = _cfgs()
    ims = np.random.RandomState(5).randint(0, 256, (2, 96, 128, 3)).astype(np.uint8)
    want = jax.jit(japi.make_propose_batch(jnet.model, jcfg, (64, 128)))(
        jnet.params, jnp.asarray(ims))
    got = tapi.make_propose_batch(tnet.model, tcfg, (64, 128))(torch.from_numpy(ims))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-3, rtol=0)


def test_im_detect_matches_resnet50():
    jcfg, tcfg = _cfgs()
    jnet = japi.build_frcnn_net(jcfg)
    tnet = tapi.build_frcnn_net(tcfg, state_dict=params_from_flax(_np_tree(jnet.params)),
                                device="cpu")
    rng = np.random.RandomState(1)
    im = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    xy = rng.uniform(0, 80, (20, 2))
    boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(8, 60, (20, 2)), 120)], 1)
    boxes = boxes.astype(np.float32)
    got = tapi.im_detect(tnet, im, boxes)
    want = japi.im_detect(jnet, im, boxes)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=2e-3, rtol=0)
