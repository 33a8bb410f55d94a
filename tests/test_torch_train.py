"""Port parity, training: the losses and their gradients, the optimizer, the
AZ and Fast R-CNN train steps, checkpoints and the bbox-weight baking, each
against the JAX package on the same NumPy inputs (smallnet, 64x64 images,
as ``tests/test_train.py``), and the port's own training contracts.

Tolerances:
- losses: values to 1e-6 relative, gradients to 1e-6 of their max |g|
  (float32 elementwise math, sums in another order); both smooth-L1 zones,
  ``d = 0``, and logits at exactly 0, where JAX's ``|x|`` has gradient 1 and
  ``maximum`` splits its gradient in half;
- the optimizer against optax: 2e-6 relative per element over 7 updates
  that cross ``STEPSIZE`` (float32 rounding; only the global norm sums in
  another order);
- three train steps from converted JAX parameters, ``DROPOUT`` 0: float32
  loss and metrics to 1e-4 relative, each parameter's update to 2e-3 of
  that parameter's largest update (the convolutions' gradients reduce in
  another order, and three steps compound it). bf16: loss and metrics to
  1e-2 relative (measured 1e-5, ``grad_norm`` 3.7e-3), each parameter's
  update at a cosine above 0.95 with JAX's and its norm within 15%
  (measured 0.979 and 6.6%, fc6's bias at the third Fast R-CNN step): bf16
  keeps 8 bits, the frameworks round the conv bias apart, a max-pool window
  tied in bf16 sends its gradient to another element in each, and momentum
  carries each difference into the next step;
- ``bake``/``unbake`` against the JAX package's on converted parameters:
  1e-6 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from aznet_tpu import train as jtrain
from aznet_tpu.config import Config as JConfig
from aznet_tpu.config import cfg_from_dict as jcfg_from_dict
from aznet_tpu.models import AZNet as JAZNet
from aznet_tpu.models import FRCNN as JFRCNN
from aznet_tpu.ops import losses as jlosses
from aznet_tpu.train.optim import make_optimizer as jmake_optimizer
from aznet_tpu.utils import checkpoint as jckpt
from aznet_tpu_torch.config import Config, cfg_from_dict
from aznet_tpu_torch.ops import losses as tlosses
from aznet_tpu_torch.train import optim as toptim
from aznet_tpu_torch.train import train_az as taz
from aznet_tpu_torch.train import train_frcnn as tfr
from aznet_tpu_torch.utils import checkpoint as tckpt
from aznet_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(2)

OVERRIDES = {
    "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 32, "NUM_TEMPLATES": 5, "NUM_CLASSES": 4,
              "COMPUTE_DTYPE": "float32", "DROPOUT": 0.0},
    "TRAIN": {"LEARNING_RATE": 0.03, "STEPSIZE": 2},
}
B, R, K, C = 2, 8, 5, 4


def _cfgs(**model):
    over = dict(OVERRIDES, MODEL=dict(OVERRIDES["MODEL"], **model))
    return jcfg_from_dict(JConfig(), over), cfg_from_dict(Config(), over)


def _az_batch(rng):
    rois = rng.uniform(0, 40, (B, R, 4)).astype(np.float32)
    rois[..., 2:] += 16.0
    return {
        "images": rng.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32),
        "rois": rois,
        "roi_valid": np.ones((B, R), bool),
        "zoom_labels": rng.randint(0, 2, (B, R)).astype(np.float32),
        "adj_labels": rng.randint(0, 2, (B, R, K)).astype(np.float32),
        "adj_targets": rng.normal(0, 0.1, (B, R, K, 4)).astype(np.float32),
        "adj_inside": np.ones((B, R, K, 4), np.float32),
    }


def _frcnn_batch(rng):
    labels = rng.randint(0, C, (B, R))
    inside = np.zeros((B, R, 4 * C), np.float32)
    targets = np.zeros((B, R, 4 * C), np.float32)
    for b in range(B):
        for r in range(R):
            if labels[b, r] > 0:
                s = 4 * labels[b, r]
                inside[b, r, s:s + 4] = 1.0
                targets[b, r, s:s + 4] = rng.normal(0, 0.1, 4)
    rois = rng.uniform(0, 40, (B, R, 4)).astype(np.float32)
    rois[..., 2:] += 16.0
    return {
        "images": rng.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32),
        "rois": rois,
        "roi_valid": np.ones((B, R), bool),
        "labels": labels.astype(np.int32),
        "bbox_targets": targets,
        "bbox_inside": inside,
    }


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state(kind, jcfg):
    model = (JAZNet if kind == "az" else JFRCNN)(model_cfg=jcfg.MODEL)
    make = jtrain.make_az_train_state if kind == "az" else jtrain.make_frcnn_train_state
    return model, make(jcfg, model, jax.random.PRNGKey(0))


def _port_state(kind, tcfg, jstate):
    make = taz.make_az_train_state if kind == "az" else tfr.make_frcnn_train_state
    return make(tcfg, device="cpu", state_dict=params_from_flax(_np_tree(jstate.params)))


def _params(state):
    return {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()}


# -- losses -----------------------------------------------------------------------


def _loss_inputs(rng):
    pred = rng.normal(0, 1.5, (6, 5, 4)).astype(np.float32)
    target = rng.normal(0, 1.5, (6, 5, 4)).astype(np.float32)
    target[0, 0] = pred[0, 0]  # d = 0 exactly
    inside = (rng.uniform(size=(6, 5, 4)) < 0.7).astype(np.float32)
    outside = rng.uniform(0.5, 1.5, (6, 5, 4)).astype(np.float32)
    logits = rng.normal(0, 3, (6, 5)).astype(np.float32)
    logits[0, :2] = 0.0
    labels = rng.randint(0, 2, (6, 5)).astype(np.float32)
    weights = (rng.uniform(size=(6, 5)) < 0.8).astype(np.float32)
    return pred, target, inside, outside, logits, labels, weights


def _grad_pair(jfn, tfn, *args):
    """(value, gradient w.r.t. the first argument) of both packages."""
    jv, jg = jax.value_and_grad(jfn)(*(jnp.asarray(a) for a in args))
    x = torch.tensor(args[0], requires_grad=True)
    tv = tfn(x, *(torch.as_tensor(a) for a in args[1:]))
    (tg,) = torch.autograd.grad(tv, x)
    return (float(jv), np.asarray(jg)), (tv.item(), tg.numpy())


def _assert_pair(pair):
    (jv, jg), (tv, tg) = pair
    assert abs(tv - jv) <= 1e-6 * max(abs(jv), 1e-3), (tv, jv)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-6 * max(np.abs(jg).max(), 1e-6))


@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_smooth_l1_and_gradient_match(sigma):
    pred, target, inside, outside, *_ = _loss_inputs(np.random.RandomState(0))
    d = np.abs((pred - target) * inside)
    assert (d < 1 / sigma ** 2).any() and (d >= 1 / sigma ** 2).any()  # both zones
    for args in ((pred, target), (pred, target, inside, outside)):
        _assert_pair(_grad_pair(
            lambda p, *a: jlosses.smooth_l1_loss(p, *a, sigma=sigma),
            lambda p, *a: tlosses.smooth_l1_loss(p, *a, sigma=sigma), *args))


def test_sigmoid_and_softmax_ce_and_gradients_match():
    *_, logits, labels, weights = _loss_inputs(np.random.RandomState(1))
    for w in (None, weights, np.zeros_like(weights)):
        extra = () if w is None else (w,)
        _assert_pair(_grad_pair(jlosses.sigmoid_ce_loss, tlosses.sigmoid_ce_loss,
                                logits, labels, *extra))
    cls = np.random.RandomState(2).randint(0, 5, (6,)).astype(np.int32)
    for w in (None, weights[:, 0]):
        extra = () if w is None else (w,)
        _assert_pair(_grad_pair(jlosses.softmax_ce_loss, tlosses.softmax_ce_loss,
                                logits, cls, *extra))


# -- optimizer --------------------------------------------------------------------


def _opt_tree(rng):
    """A tree with a trunk and a head, kernels, biases and a FrozenBN scale."""
    leaf = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    return {"params": {
        "trunk": {"conv1": {"kernel": leaf(3, 3, 2, 4), "bias": leaf(4)},
                  "bn1": {"scale": leaf(4), "bias": leaf(4)}},
        "head": {"fc": {"fc6": {"kernel": leaf(8, 6), "bias": leaf(6)}},
                 "cls_score": {"kernel": leaf(6, 3), "bias": leaf(3)}}}}


@pytest.mark.parametrize("clip,freeze", [(0.0, ()), (1.0, ()), (1e3, ()),
                                         (1.0, ("conv1",)), (0.0, ("trunk",))],
                         ids=["no_clip", "clip_below_norm", "clip_above_norm",
                              "clip_freeze_conv1", "freeze_trunk"])
def test_optimizer_matches_optax(clip, freeze):
    """7 updates at STEPSIZE 3 (the rate steps twice), weight decay on the
    kernels only, with GRAD_CLIP on both sides of the gradients' norm and
    FREEZE_PREFIXES."""
    tcfg = dataclasses.replace(Config().TRAIN, LEARNING_RATE=0.05, STEPSIZE=3, GAMMA=0.1,
                               WEIGHT_DECAY=5e-3, MOMENTUM=0.9, GRAD_CLIP=clip,
                               FREEZE_PREFIXES=freeze)
    jtcfg = dataclasses.replace(JConfig().TRAIN, **{f.name: getattr(tcfg, f.name)
                                                   for f in dataclasses.fields(tcfg)})
    rng = np.random.RandomState(3)
    tree = _opt_tree(rng)
    tx = jmake_optimizer(jtcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(v) for k, v in params_from_flax(tree).items()}
    opt = toptim.SGD(tp, tcfg)
    for _ in range(7):
        grads = jax.tree_util.tree_map(lambda x: rng.normal(0, 3, x.shape).astype(np.float32),
                                       tree)
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step({k: v for k, v in params_from_flax(grads).items()})
        want = params_from_flax(_np_tree(jp))
        for k, v in tp.items():
            np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(), rtol=2e-6,
                                       atol=1e-7, err_msg=k)
    if freeze:
        start = params_from_flax(tree)
        for k, v in tp.items():
            if toptim.frozen(k, freeze):
                np.testing.assert_array_equal(v.detach().numpy(), start[k].numpy())


def test_lr_schedule_matches_optax():
    tcfg = dataclasses.replace(Config().TRAIN, LEARNING_RATE=0.03, STEPSIZE=1000, GAMMA=0.1)
    jsched = jtrain.lr_schedule(dataclasses.replace(JConfig().TRAIN, LEARNING_RATE=0.03,
                                                    STEPSIZE=1000, GAMMA=0.1))
    sched = toptim.lr_schedule(tcfg)
    for count in (0, 1, 999, 1000, 2500, 30000):
        assert float(sched(count)) == float(np.float32(jsched(count))), count


# -- train steps against JAX ---------------------------------------------------------


def _steps_against_jax(kind, dtype, n=3):
    jcfg, tcfg = _cfgs(COMPUTE_DTYPE=dtype)
    jmodel, jstate = _jax_state(kind, jcfg)
    state = _port_state(kind, tcfg, jstate)
    jstep = jax.jit(jtrain.make_az_train_step(jmodel) if kind == "az"
                    else jtrain.make_frcnn_train_step(jmodel))
    step = (taz.make_az_train_step(state.model) if kind == "az"
            else tfr.make_frcnn_train_step(state.model))
    make = _az_batch if kind == "az" else _frcnn_batch
    rng = np.random.RandomState(11)
    out = []
    for _ in range(n):
        batch = make(rng)
        before_j = params_from_flax(_np_tree(jstate.params))
        before_t = _params(state)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(5))
        tm = step(state, batch, 5)
        after_j = params_from_flax(_np_tree(jstate.params))
        after_t = _params(state)
        upd = {k: (after_t[k] - before_t[k], after_j[k].numpy() - before_j[k].numpy())
               for k in after_t}
        out.append(({k: float(v) for k, v in tm.items()}, {k: float(v) for k, v in jm.items()},
                    upd))
    assert state.step == n and int(jstate.step) == n
    return out


@pytest.mark.parametrize("kind", ["az", "frcnn"])
def test_train_steps_match_jax_float32(kind):
    for tm, jm, upd in _steps_against_jax(kind, "float32"):
        assert sorted(tm) == sorted(jm)
        for key in jm:
            assert abs(tm[key] - jm[key]) <= 1e-4 * max(abs(jm[key]), 1e-3), (key, tm, jm)
        for name, (got, want) in upd.items():
            scale = np.abs(want).max()
            assert scale > 0, name
            assert np.abs(got - want).max() <= 2e-3 * scale, (name, np.abs(got - want).max(),
                                                               scale)


@pytest.mark.parametrize("kind", ["az", "frcnn"])
def test_train_steps_match_jax_bfloat16(kind):
    for tm, jm, upd in _steps_against_jax(kind, "bfloat16"):
        for key in jm:
            assert abs(tm[key] - jm[key]) <= 1e-2 * max(abs(jm[key]), 1e-3), (key, tm, jm)
        for name, (got, want) in upd.items():
            g, w = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
            cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
            assert cos > 0.95, (name, cos)
            assert abs(np.linalg.norm(g) / np.linalg.norm(w) - 1) <= 0.15, name


# -- the port's own contracts ---------------------------------------------------------


def _state(kind="az", **model):
    _, tcfg = _cfgs(**model)
    tcfg = dataclasses.replace(tcfg, TRAIN=dataclasses.replace(tcfg.TRAIN, STEPSIZE=1000))
    make = taz.make_az_train_state if kind == "az" else tfr.make_frcnn_train_state
    return tcfg, make(tcfg, device="cpu", seed=0)


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_masked_rois_do_not_contribute():
    _, state = _state()
    batch = _az_batch(np.random.RandomState(3))
    batch["roi_valid"][:, R // 2:] = False
    corrupted = dict(batch, zoom_labels=batch["zoom_labels"].copy(),
                     adj_labels=batch["adj_labels"].copy(),
                     adj_targets=batch["adj_targets"] + 0.0)
    corrupted["zoom_labels"][:, R // 2:] = 1.0
    corrupted["adj_labels"][:, R // 2:] = 1.0
    corrupted["adj_targets"][:, R // 2:] += 5.0
    with torch.no_grad():
        a = taz.az_loss(state.model, _tensors(batch))[0]
        b = taz.az_loss(state.model, _tensors(corrupted))[0]
    assert abs(float(a) - float(b)) < 1e-5


def test_dropout_masks_differ_per_image_and_follow_the_step():
    """Two identical images in a batch get different dropout masks; the
    generator of a step is a function of (seed, step), so a resumed run draws
    the masks an uninterrupted one would; rate 0 is the identity."""
    _, state = _state(DROPOUT=0.5)
    batch = _az_batch(np.random.RandomState(5))
    for v in batch.values():
        v[1] = v[0]
    with torch.no_grad():
        out = taz.head_outputs(state.model, _tensors(batch), taz.dropout_generator(3, 7, "cpu"))
        again = taz.head_outputs(state.model, _tensors(batch), taz.dropout_generator(3, 7, "cpu"))
        other = taz.head_outputs(state.model, _tensors(batch), taz.dropout_generator(3, 8, "cpu"))
    assert not torch.allclose(out["zoom"][0], out["zoom"][1])
    assert torch.equal(out["zoom"], again["zoom"])
    assert not torch.equal(out["zoom"], other["zoom"])
    x = torch.randn(4, 6)
    from aznet_tpu_torch.models.heads import dropout
    assert dropout(x, 0.0, None) is x


def test_frozen_prefixes_exactly_frozen_under_weight_decay():
    tcfg, state = _state()
    tcfg = dataclasses.replace(tcfg, TRAIN=dataclasses.replace(
        tcfg.TRAIN, FREEZE_PREFIXES=("trunk",), WEIGHT_DECAY=5e-4, LEARNING_RATE=0.1,
        GRAD_CLIP=10.0))
    state.opt = toptim.SGD(dict(state.model.named_parameters()), tcfg.TRAIN)
    before = _params(state)
    step = taz.make_az_train_step(state.model)
    batch = _az_batch(np.random.RandomState(6))
    for _ in range(3):
        metrics = step(state, batch, 0)
    after = _params(state)
    for k in before:
        if k.startswith("trunk."):
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
        else:
            assert not np.array_equal(after[k], before[k]), k
    assert float(metrics["grad_norm"]) > 0  # the raw gradients, frozen ones included


@pytest.mark.parametrize("model", [{}, {"BACKBONE": "vgg16", "WIDTH": 0.125}],
                         ids=["smallnet_one_region", "vgg16_per_layer"])
def test_remat_trunk_gives_the_same_step(model):
    """REMAT_TRUNK changes what is kept for the backward pass, not the math:
    the same loss, and the same update to float32 rounding (the recomputed
    layers run the same kernels; only the gradient sums may associate
    differently)."""
    _, a = _state(**model)
    _, b = _state(**model)
    batch = _az_batch(np.random.RandomState(3))
    ma = taz.make_az_train_step(a.model)(a, batch, 7)
    mb = taz.make_az_train_step(b.model, remat_trunk=True)(b, batch, 7)
    assert float(ma["loss"]) == float(mb["loss"])
    pa, pb = _params(a), _params(b)
    for k in pa:
        np.testing.assert_allclose(pb[k], pa[k], rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("kind", ["az", "frcnn"])
def test_overfit_fixed_batch(kind):
    """60 steps on one batch cut the loss below 0.8x (tests/test_train.py)."""
    _, state = _state(kind, DROPOUT=0.1)
    loss_fn = taz.az_loss if kind == "az" else tfr.frcnn_loss
    step = (taz.make_az_train_step if kind == "az" else tfr.make_frcnn_train_step)(state.model)
    batch = (_az_batch if kind == "az" else _frcnn_batch)(np.random.RandomState(1))
    with torch.no_grad():
        loss0 = float(loss_fn(state.model, _tensors(batch))[0])
    for _ in range(60):
        metrics = step(state, batch, 42)
    with torch.no_grad():
        loss1 = float(loss_fn(state.model, _tensors(batch))[0])
    assert loss1 < 0.8 * loss0, (loss0, loss1)
    assert float(metrics["grad_norm"]) > 0 and np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("model,match", [
    ({"BACKBONE": "vgg16", "WIDTH": 0.125, "FUSE_CONV1": True}, "FUSE_CONV1"),
    ({"POOLING_MODE": "align_pallas"}, "align_pallas"),
    ({"BACKBONE": "vgg16", "WIDTH": 0.125, "COMPUTE_DTYPE": "int8",
      "INT8_SCALES": (0.5,) * 13, "INT8_BACKEND": "pallas_strip"}, "int8"),
], ids=["fuse_conv1", "align_pallas", "int8"])
def test_inference_only_paths_raise_under_grad(model, match):
    """What the reference cannot differentiate raises when autograd records,
    with no fallback; under no_grad the same model runs."""
    _, state = _state(**model)
    state.model.prepare_int8()
    batch = _tensors(_az_batch(np.random.RandomState(2)))
    with pytest.raises(RuntimeError, match=match):
        taz.az_loss(state.model, batch)
    with torch.no_grad():
        loss, _ = taz.az_loss(state.model, batch)
    assert torch.isfinite(loss)


def test_train_entry_points_need_a_card_by_default():
    from aznet_tpu_torch.train.loop import train_az_net, train_frcnn_net

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_az_net(_cfgs()[1], "synthetic_train", max_iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_frcnn_net(_cfgs()[1], "synthetic_train", lambda i: np.zeros((1, 4)), max_iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        taz.make_az_train_state(_cfgs()[1])


# -- checkpoints and baking -----------------------------------------------------------


def test_checkpointer_contract(tmp_path, capsys):
    ck = tckpt.Checkpointer(str(tmp_path), prefix="t")
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore({"params": 0})
    tree = lambda s: {"params": {"w": torch.full((2, 3), float(s))},  # noqa: E731
                      "opt_state": {"momentum": {"w": torch.ones(2)}, "count": s}, "step": s}
    for s in range(1, 8):
        ck.save(s, tree(s))
    assert ck.all_steps() == [3, 4, 5, 6, 7] and ck.latest_step() == 7  # keep 5
    ck.save(7, tree(100))  # idempotent: the existing step stays
    assert "already exists" in capsys.readouterr().out
    full, step = ck.restore({"params": 0, "opt_state": 0, "step": 0})
    assert step == 7 and full["step"] == 7 and full["opt_state"]["count"] == 7
    assert torch.equal(full["params"]["w"], torch.full((2, 3), 7.0))
    sub, step = ck.restore({"params": 0}, step=4)  # a sub-tree: the parameters only
    assert step == 4 and list(sub) == ["params"] and float(sub["params"]["w"][0, 0]) == 4.0
    with pytest.raises(KeyError):
        ck.restore({"nothing": 0})


@pytest.mark.parametrize("kind,head", [("az", "adj_bbox"), ("frcnn", "bbox_pred")])
def test_bake_unbake_match_jax(kind, head):
    jcfg, _ = _cfgs()
    _, jstate = _jax_state(kind, jcfg)
    means, stds = (0.01, -0.02, 0.03, 0.0), (0.1, 0.1, 0.2, 0.25)
    params = _np_tree(jstate.params)
    sd = params_from_flax(params)
    baked = tckpt.bake_bbox_normalization(sd, means, stds, head_name=head)
    want = params_from_flax(_np_tree(jckpt.bake_bbox_normalization(params, means, stds,
                                                                   head_name=head)))
    for k in sd:
        np.testing.assert_allclose(baked[k].numpy(), want[k].numpy(), rtol=1e-6, atol=0,
                                   err_msg=k)
        if head not in k:
            assert baked[k] is sd[k]
    back = tckpt.unbake_bbox_normalization(baked, means, stds, head_name=head)
    for k in sd:
        np.testing.assert_allclose(back[k].numpy(), sd[k].numpy(), rtol=1e-5, atol=1e-9)
    with pytest.raises(KeyError):
        tckpt.bake_bbox_normalization(sd, means, stds, head_name="nope")
