"""The port computes float32 in float32 whatever the caller's TF32 flags
(``aznet_tpu_torch/utils/precision.py``).

A ``TorchFunctionMode`` spy records, at every float32 convolution and
matmul of a forward, the two per-operator settings that decide TF32 on the
card (``torch.backends.cudnn.conv.fp32_precision``,
``torch.backends.cuda.matmul.fp32_precision``, which the legacy
``allow_tf32`` flags also write). They are process state that the CPU
build reads and writes as the CUDA build does, so the scope is checked
here; whether the card honours it is ``tests/test_torch_cuda.py``'s and
``chip_smoke.py``'s part. The tests turn TF32 on for both, as a caller may,
through the legacy flags or the per-operator values, and hold the port to:
``'ieee'`` in every float32 call, the caller's settings back afterwards,
and VGG-16's int8 prefix (bf16-valued operands, exact in TF32) with cuDNN
TF32 on.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from aznet_tpu_torch import api as tapi
from aznet_tpu_torch.config import Config, cfg_from_dict
from aznet_tpu_torch.models.vgg import VGG16Trunk
from aznet_tpu_torch.utils.precision import float32_precision

torch.set_num_threads(2)

WATCHED = {"conv2d", "matmul", "einsum", "linear", "mm", "bmm", "addmm"}  # `@` is "matmul"


def settings():
    """The per-operator float32 precision of cuDNN convolutions and cuBLAS
    matmuls (readable whichever API set them)."""
    return torch.backends.cudnn.conv.fp32_precision, torch.backends.cuda.matmul.fp32_precision


def legacy():
    """The legacy getters, or None where PyTorch refuses to read one (after
    a per-operator value was set on its own)."""
    out = []
    for get in (lambda: torch.backends.cudnn.allow_tf32,
                lambda: torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision):
        try:
            out.append(get())
        except RuntimeError:
            out.append(None)
    return tuple(out)


def set_legacy(cudnn: bool, matmul: str):
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.set_float32_matmul_precision(matmul)


def set_per_operator(conv: str, matmul: str):
    torch.backends.cudnn.conv.fp32_precision = conv
    torch.backends.cuda.matmul.fp32_precision = matmul


@pytest.fixture
def restore_settings():
    """The process's settings back after the test."""
    prev = settings(), legacy()
    yield
    if None not in prev[1]:
        set_legacy(prev[1][0], prev[1][2])
    set_per_operator(*prev[0])


class FlagSpy(TorchFunctionMode):
    """Records ``(op, float32?, conv precision, matmul precision)`` at each
    watched call."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in WATCHED:
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            tensors += [t for a in args if isinstance(a, (list, tuple))
                        for t in a if isinstance(t, torch.Tensor)]
            f32 = any(t.dtype == torch.float32 for t in tensors)
            self.calls.append((name, f32) + settings())
        return func(*args, **(kwargs or {}))


@pytest.fixture(params=["legacy", "per_operator"])
def caller_tf32(request, restore_settings):
    """TF32 on for both cuDNN and cuBLAS, set through the legacy flags or
    the per-operator values; yields the settings to find again after."""
    if request.param == "legacy":
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    else:
        set_per_operator("tf32", "tf32")
    yield settings(), legacy()


def _assert_scoped(spy, ops, before):
    f32 = [c for c in spy.calls if c[1]]
    assert {c[0] for c in f32} >= ops, spy.calls
    bad = [c for c in f32 if c[2:] != ("ieee", "ieee")]
    assert not bad, bad
    assert (settings(), legacy()) == before
    assert settings() == ("tf32", "tf32")


def _small_cfg(**model):
    model = {"COMPUTE_DTYPE": "float32", "FC_DIM": 64, "NUM_TEMPLATES": 11, **model}
    return cfg_from_dict(Config(), {
        "MODEL": model,
        "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 256, "MAX_LEVELS": 3, "NUM_PROPOSALS": 50},
        "TEST": {"SCALES": (64,), "MAX_SIZE": 128}})


@pytest.mark.parametrize("model", [
    {"BACKBONE": "vgg16", "WIDTH": 0.125},
    {"BACKBONE": "vgg16", "WIDTH": 0.125, "FUSE_CONV1": True},
    {"BACKBONE": "resnet50", "STEM_S2D": False},
    {"BACKBONE": "caffenet", "POOL_SIZE": 6},
], ids=["vgg16", "vgg16_fuse_conv1", "resnet50", "caffenet"])
def test_float32_trunk_runs_without_tf32(caller_tf32, model):
    net = tapi.build_az_net(_small_cfg(**model), device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).uniform(-120, 120, (1, 64, 96, 3))
                         .astype(np.float32))
    with torch.inference_mode(), FlagSpy() as spy:
        feat = net.model.features(x)
    assert feat.dtype == torch.float32 and torch.isfinite(feat).all()
    _assert_scoped(spy, {"conv2d"} | ({"matmul"} if "FUSE_CONV1" in model else set()),
                   caller_tf32)


def test_float32_propose_path_runs_without_tf32(caller_tf32):
    """im_propose in float32 on VGG-16: the preprocess matmuls, the trunk,
    the einsum ROI align, fc6/fc7 and the heads' fused f32 dot."""
    net = tapi.build_az_net(_small_cfg(WIDTH=0.125), device="cpu")
    im = np.random.RandomState(1).randint(0, 256, (48, 64, 3)).astype(np.uint8)
    with FlagSpy() as spy:
        dets = tapi.im_propose(net, im)
    assert dets.ndim == 2 and dets.shape[0] >= 1 and np.isfinite(dets).all()
    _assert_scoped(spy, {"conv2d", "matmul", "einsum", "linear"}, caller_tf32)


def test_int8_prefix_keeps_cudnn_tf32(restore_settings):
    """The int8 prefix's float32 convs run on bf16 values, where TF32 is
    exact: the scope turns cuDNN TF32 on there, and the caller's False
    comes back."""
    torch.manual_seed(0)
    trunk = VGG16Trunk(width=0.125, int8_mode=True,
                       int8_scales=tuple(np.linspace(0.3, 0.05, 13)))
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode(), FlagSpy() as spy:
        codes = trunk.int8_prefix(torch.randn(1, 32, 48, 3) * 50)
    assert codes.dtype == torch.int8
    convs = [c for c in spy.calls if c[0] == "conv2d"]
    assert len(convs) == 3 and all(c[1] and c[2] == "tf32" for c in convs), convs
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("caller", [
    ("legacy", True, "high"), ("legacy", False, "highest"), ("legacy", True, "medium"),
    ("per_operator", "ieee", "tf32"), ("per_operator", "tf32", "none"),
], ids=["legacy_tf32", "legacy_f32", "legacy_medium", "conv_ieee_matmul_tf32", "conv_tf32"])
def test_scope_restores_the_callers_settings(restore_settings, caller):
    """Nested scopes, an exception inside one, and the decorator form each
    leave the caller's exact settings, whichever API set them (``medium``
    included, and a per-operator value set on its own, which makes a legacy
    getter raise)."""
    (set_legacy if caller[0] == "legacy" else set_per_operator)(*caller[1:])
    before = settings(), legacy()
    seen = []

    @float32_precision()
    def inner():
        seen.append(settings())

    with pytest.raises(KeyError):
        with float32_precision(tf32=True):
            seen.append(settings())
            inner()
            seen.append(settings())
            raise KeyError
    assert seen == [("tf32", "tf32"), ("ieee", "ieee"), ("tf32", "tf32")]
    assert (settings(), legacy()) == before
