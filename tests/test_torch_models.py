"""Port parity, models: trunks, AZ head and AZNet.roi_forward with the JAX
package's weights (converted by ``params_from_flax``) on the same inputs.

Tolerance: f32 results agree to 1e-4 of the output's max |x| (convolution
and matmul reductions run in another order); the bf16 trunk to 2e-2 of max
|x| (measured 3.5e-3; bf16 keeps 8 bits, and the two frameworks round at different places:
flax adds the conv bias in bf16, cuDNN/oneDNN in f32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aznet_tpu.config import ModelConfig
from aznet_tpu.models.aznet import AZNet as JAZNet
from aznet_tpu.models.heads import AZHead as JAZHead
from aznet_tpu.models.small import SmallTrunk as JSmallTrunk
from aznet_tpu.models.vgg import VGG16Trunk as JVGG16Trunk
from aznet_tpu_torch.models.aznet import AZNet
from aznet_tpu_torch.models.heads import AZHead
from aznet_tpu_torch.models.small import SmallTrunk
from aznet_tpu_torch.models.vgg import VGG16Trunk
from aznet_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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


@pytest.mark.parametrize("hw", [(64, 96), (70, 90)])
def test_small_trunk_matches(hw):
    """Even and odd sizes: stride-2 SAME pads (1, 2)/(0, 1) on even inputs,
    (2, 2)/(1, 1) on odd ones."""
    x = np.random.RandomState(0).uniform(-1, 1, (2,) + hw + (3,)).astype(np.float32)
    jm = JSmallTrunk(dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = _load(SmallTrunk(), params)(torch.from_numpy(x))
    _assert_rel(got, want, 1e-4)


def test_vgg16_trunk_matches_f32():
    x = np.random.RandomState(1).uniform(-50, 50, (2, 64, 80, 3)).astype(np.float32)
    jm = JVGG16Trunk(dtype=jnp.float32, width=0.125)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = _load(VGG16Trunk(width=0.125), params)(torch.from_numpy(x))
    assert got.shape == (2, 4, 5, 64)
    _assert_rel(got, want, 1e-4)


def test_vgg16_trunk_matches_bf16():
    x = np.random.RandomState(2).uniform(-50, 50, (1, 64, 64, 3)).astype(np.float32)
    jm = JVGG16Trunk(dtype=jnp.bfloat16, width=0.125)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        tm = _load(VGG16Trunk(width=0.125), params).to(torch.bfloat16)
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    _assert_rel(got.float(), np.asarray(want, np.float32), 2e-2)


def test_az_head_matches():
    pooled = np.random.RandomState(3).uniform(0, 2, (20, 7, 7, 16)).astype(np.float32)
    jm = JAZHead(num_templates=11, fc_dim=64, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(pooled))
    want = jm.apply(params, jnp.asarray(pooled))
    with torch.no_grad():
        got = _load(AZHead(7 * 7 * 16, 11, 64), params)(torch.from_numpy(pooled))
    for key in ("zoom", "adj_score", "adj_delta"):
        _assert_rel(got[key], want[key], 1e-4)


def test_aznet_roi_forward_matches():
    mc = ModelConfig(BACKBONE="vgg16", WIDTH=0.125, FC_DIM=64, COMPUTE_DTYPE="float32")
    rng = np.random.RandomState(4)
    images = rng.uniform(-50, 50, (1, 96, 128, 3)).astype(np.float32)
    xy = rng.uniform(0, 80, (30, 2)).astype(np.float32)
    rois = np.concatenate([xy, xy + rng.uniform(8, 60, (30, 2)).astype(np.float32)], 1)
    jm = JAZNet(model_cfg=mc)
    params = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.asarray(images), jnp.asarray(rois))
    feat = jm.apply(params, jnp.asarray(images), method="features")[0]
    want = jm.apply(params, feat, jnp.asarray(rois), method="roi_forward")
    tm = _load(AZNet(mc), params)
    with torch.no_grad():
        tfeat = tm.features(torch.from_numpy(images))[0]
        got = tm.roi_forward(tfeat, torch.from_numpy(rois))
    _assert_rel(tfeat, feat, 1e-4)
    for key in ("zoom", "adj_score", "adj_delta"):
        _assert_rel(got[key], want[key], 1e-4)


@pytest.mark.parametrize("override,match", [
    (dict(COMPUTE_DTYPE="int8", INT8_BACKEND="cuda"), "COMPUTE_DTYPE"),
    (dict(COMPUTE_DTYPE="int8", INT8_CHAIN_FROM="conv1_1"), "int8"),
    (dict(COMPUTE_DTYPE="float16"), "COMPUTE_DTYPE"),
    (dict(POOLING_MODE="bilinear"), "POOLING_MODE"),
    (dict(BACKBONE="resnet101"), "unknown backbone"),
])
def test_unported_settings_raise(override, match):
    import dataclasses

    with pytest.raises((NotImplementedError, ValueError), match=match):
        AZNet(dataclasses.replace(ModelConfig(WIDTH=0.125, FC_DIM=16), **override))


def test_conv1_s2d_is_ignored_with_a_warning():
    with pytest.warns(UserWarning, match="CONV1_S2D"):
        AZNet(ModelConfig(WIDTH=0.125, FC_DIM=16, CONV1_S2D=True))
