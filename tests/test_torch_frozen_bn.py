"""Frozen BatchNorm's epilogue (``ops/frozen_bn.py``, the kernel
``csrc/frozen_bn.cu``): the affine, the residual add and the ReLU after each
ResNet convolution.

On the CPU: the plain version is the trunk's former chain of operations,
bit for bit (±0, NaN, ±inf and subnormals in the inputs and the scales);
``Bottleneck`` and ``ResNet50Trunk`` on the CPU, float and int8, and under
autograd, equal the former ``forward``, outputs and gradients, without
reaching the card's entry. On the card (``cuda``): the kernel's three forms
against the plain version bit for bit at every epilogue shape of the
``resnet50_1080p`` cell (batch 4 on 1088x1920) in bf16 and float32, at row
counts that are no multiple of the grid's stride, the wrapper's refusals, a
whole trunk call against the plain chain with its 40 launches, and the
train step's path; the same forms at the C4 detector's conv5_x head's
shapes (300 pools of 14x14, C 512 and 2048). Imports no JAX, so it runs where JAX is absent:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_frozen_bn.py

Without a CUDA device the ``cuda`` tests skip (the kernel has no CPU mode).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aznet_tpu_torch.kernels import equal_bits
from aznet_tpu_torch.models import resnet
from aznet_tpu_torch.ops import frozen_bn
from aznet_tpu_torch.ops.conv_int8 import conv1x1_int8, quantize_acts
from aznet_tpu_torch.ops.cuda import frozen_bn_kernel

FORMS = ("affine_relu", "affine_add_relu", "affine_affine_add_relu")
SPECIALS = (0.0, -0.0, float("nan"), float("inf"), float("-inf"), 1e-40, -3e-39, 3e38, -3e38)

# (C, H, W, form) of every epilogue of a ResNet-50 trunk call on a 1088x1920
# canvas (the ``resnet50_1080p`` cell): the stem, then each stage's conv1,
# conv2 and conv3 outputs, conv3 with the downsample's affine in a stage's
# first block and with the block input after it.
CELL_SHAPES = (
    (64, 544, 960, 0),
    (64, 272, 480, 0), (256, 272, 480, 2), (256, 272, 480, 1),
    (128, 272, 480, 0), (128, 136, 240, 0), (512, 136, 240, 2), (512, 136, 240, 1),
    (256, 136, 240, 0), (256, 68, 120, 0), (1024, 68, 120, 2), (1024, 68, 120, 1),
)
CELL_BATCH = 4
# (C, H, W, form) of every epilogue of the C4 detector's conv5_x head
# (``resnet101_c4``) on one image's 300 pools of 14x14: conv5_1's conv1 at
# 14x14, then 7x7 (conv3 with the downsample's affine in conv5_1 and with
# the block input after it).
HEAD_SHAPES = ((512, 14, 14, 0), (512, 7, 7, 0), (2048, 7, 7, 2), (2048, 7, 7, 1))
HEAD_ROWS = 300


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


def _sprinkle(t: torch.Tensor, g: torch.Generator, share: float = 0.01) -> torch.Tensor:
    """``t`` with about ``share`` of its elements (at least one of each)
    replaced by :data:`SPECIALS`, in place."""
    flat = t.view(-1)
    n = max(len(SPECIALS), int(flat.numel() * share))
    idx = torch.randint(0, flat.numel(), (n,), generator=g, device=g.device).to(t.device)
    vals = torch.tensor(SPECIALS, dtype=t.dtype).repeat(-(-n // len(SPECIALS)))[:n]
    flat[idx] = vals.to(t.device)
    k = min(len(SPECIALS), flat.numel())
    flat[:k] = torch.tensor(SPECIALS[:k], dtype=t.dtype).to(t.device)
    return t


def case(c, h, w, form, dtype, device, n=1, seed=0, specials=True):
    """Arguments of ``frozen_bn_relu`` for one form: ``y`` and ``r`` NCHW
    ``[n, c, h, w]`` in channels-last memory, the scales about 1 and the
    biases about 0.1, ±0, NaN, ±inf, subnormals and values near the largest
    in all of them when ``specials``."""
    g = torch.Generator(device).manual_seed(seed)

    def act(scale):
        t = scale * torch.randn((n, h, w, c), generator=g, device=device)
        t = t.to(dtype)
        return (_sprinkle(t, g) if specials else t).permute(0, 3, 1, 2)

    def chan(mean, std):
        t = (mean + std * torch.randn(c, generator=g, device=device)).to(dtype)
        if specials and c >= 2 * len(SPECIALS):
            t[1::2][:len(SPECIALS)] = torch.tensor(SPECIALS, dtype=dtype).to(device)
        return t

    args = [act(2.0), chan(1.0, 0.1), chan(0.0, 0.1)]
    if form >= 1:
        args.append(act(1.0))
    if form == 2:
        args += [chan(1.0, 0.1), chan(0.0, 0.1)]
    return args


def old_chain(y, s, b, r=None, sr=None, br=None):
    """The trunk's epilogue before the kernel, through ``FrozenBN`` modules:
    ``F.relu(bn(y))``, ``F.relu(bn3(y) + x)``, ``F.relu(bn3(y) +
    downsample_bn(d))``."""
    def bn(scale, bias):
        m = resnet.FrozenBN(scale.shape[0]).to(scale.device)
        with torch.no_grad():
            m.scale.copy_(scale.float())
            m.bias.copy_(bias.float())
        return m

    out = bn(s, b)(y)
    if r is None:
        return F.relu(out)
    return F.relu(out + (r if sr is None else bn(sr, br)(r)))


def parent_block(block, x):
    """``Bottleneck.forward`` before the kernel, operation for operation."""
    dt = x.dtype
    y = F.relu(block.bn1(F.conv2d(x, block.conv1.weight.to(dt))))
    y = F.relu(block.bn2(block._conv2(y)))
    y = block.bn3(F.conv2d(y, block.conv3.weight.to(dt)))
    residual = x
    if block.downsample is not None:
        residual = block.downsample_bn(
            F.conv2d(x, block.downsample.weight.to(dt), stride=block.stride))
    return F.relu(y + residual)


def parent_int8_block(block, x, s_in, s_mid):
    """``Bottleneck._int8_forward`` before the kernel."""
    dt = x.dtype

    def conv(x8, s_x, name, stride=1):
        w_q, s_w = block._int8[name]
        x8 = x8[:, :, ::stride, ::stride].permute(0, 2, 3, 1)
        return conv1x1_int8(x8, s_x, w_q, s_w, out_dtype=dt).permute(0, 3, 1, 2)

    xq = quantize_acts(x, s_in)
    y = F.relu(block.bn1(conv(xq, s_in, "conv1")))
    y = F.relu(block.bn2(block._conv2(y)))
    y = block.bn3(conv(quantize_acts(y, s_mid), s_mid, "conv3"))
    residual = x
    if block.downsample is not None:
        residual = block.downsample_bn(conv(xq, s_in, "downsample", block.stride))
    return F.relu(y + residual)


def parent_trunk(trunk, x):
    """``ResNet50Trunk.forward`` (float path) before the kernel."""
    dt = trunk.dtype or trunk.conv1.weight.dtype
    x = x.to(dt).permute(0, 3, 1, 2)
    x = F.relu(trunk.bn1(F.conv2d(x, trunk.conv1.weight.to(dt), stride=2, padding=3)))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for block in trunk.blocks():
        x = parent_block(block, x)
    return x.permute(0, 2, 3, 1)


def _randomize(module, seed=0):
    """Conv weights at 1/sqrt(fan-in), FrozenBN scales 1 + 0.1 N and biases
    0.1 N (the benchmark's draw)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim == 4:
                p.copy_(torch.randn(p.shape, generator=g) / np.sqrt(p[0].numel()))
            elif name.endswith("scale"):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return module


@pytest.fixture
def no_card_entry(monkeypatch):
    """The card's entry replaced by one that fails the test if called."""
    def refuse(*args, **kwargs):
        raise AssertionError("the card's entry was called")

    monkeypatch.setattr(frozen_bn_kernel, "frozen_bn_relu_cuda", refuse)


def _assert_bits(got, want, what=""):
    ok, differ = equal_bits(got, want)
    assert ok, f"{what}: {differ:.3%} of {want.numel()} elements differ"


# -- CPU -----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", range(3), ids=FORMS)
def test_plain_version_is_the_old_chain(no_card_entry, dtype, form):
    args = case(24, 5, 7, form, dtype, torch.device("cpu"), n=2, seed=form)
    want = old_chain(*args)
    _assert_bits(frozen_bn.frozen_bn_relu_reference(*args), want, "plain")
    _assert_bits(frozen_bn.frozen_bn_relu(*args), want, "dispatch on the CPU")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c_in,channels,stride", [(64, 16, 1), (64, 16, 2), (32, 16, 1)],
                         ids=["identity", "downsample_s2", "downsample_s1"])
def test_bottleneck_on_the_cpu_is_the_parent(no_card_entry, dtype, c_in, channels, stride):
    block = _randomize(resnet.Bottleneck(c_in, channels, stride)).to(dtype)
    x = torch.randn(2, c_in, 9, 11).to(dtype).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        _assert_bits(block(x), parent_block(block, x))


@pytest.mark.parametrize("c_in,stride", [(64, 1), (32, 2)], ids=["identity", "downsample"])
def test_bottleneck_under_autograd_keeps_the_parents_gradients(no_card_entry, c_in, stride):
    """Float32 masters, bf16 compute, as the train step runs the trunk."""
    grads = []
    for fwd in (lambda b, x: b(x), parent_block):
        block = _randomize(resnet.Bottleneck(c_in, 16, stride), seed=3)
        x = torch.randn(2, c_in, 8, 10, generator=torch.Generator().manual_seed(4))
        x = x.to(torch.bfloat16).requires_grad_()
        out = fwd(block, x)
        out.float().square().sum().backward()
        grads.append([out.detach(), x.grad] + [p.grad for p in block.parameters()])
    assert len(grads[0]) == len(grads[1])
    for got, want in zip(*grads):
        _assert_bits(got, want)


def test_int8_bottleneck_on_the_cpu_is_the_parent(no_card_entry):
    block = _randomize(resnet.Bottleneck(64, 32, 2), seed=5)
    block.prepare_int8()
    x = torch.relu(torch.randn(2, 64, 10, 12)).to(torch.bfloat16)
    with torch.no_grad():
        _assert_bits(block(x, (0.03, 0.02)), parent_int8_block(block, x, 0.03, 0.02))


def test_trunk_on_the_cpu_is_the_parent(no_card_entry):
    trunk = _randomize(resnet.ResNet50Trunk(dtype=torch.bfloat16), seed=6)
    x = 50 * torch.randn(1, 32, 48, 3, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        got = trunk(x)
        want = parent_trunk(trunk, x)
    assert got.shape == (1, 2, 3, 1024)
    _assert_bits(got, want)


def test_the_card_entry_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        frozen_bn_kernel.frozen_bn_relu_cuda(*case(8, 2, 2, 0, torch.float32,
                                                   torch.device("cpu")))


# -- the card ------------------------------------------------------------------

def _card_and_plain(args):
    """(the kernel's result, the plain version's) on copies of ``args``."""
    want = frozen_bn.frozen_bn_relu_reference(*args)
    y = args[0].clone(memory_format=torch.channels_last)
    before = frozen_bn_kernel.LAUNCHES
    got = frozen_bn_kernel.frozen_bn_relu_cuda(y, *args[1:])
    assert frozen_bn_kernel.LAUNCHES == before + 1
    assert got.data_ptr() == y.data_ptr()  # written into y
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,h,w,form", CELL_SHAPES,
                         ids=[f"{c}x{h}x{w}-{FORMS[f]}" for c, h, w, f in CELL_SHAPES])
def test_forms_bit_for_bit_at_the_cells_shapes(dev, dtype, c, h, w, form):
    with torch.inference_mode():
        args = case(c, h, w, form, dtype, dev, n=CELL_BATCH, seed=c + h + form)
        got, want = _card_and_plain(args)
    _assert_bits(got, want, f"{FORMS[form]} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,h,w,form", HEAD_SHAPES,
                         ids=[f"{c}x{h}x{w}-{FORMS[f]}" for c, h, w, f in HEAD_SHAPES])
def test_forms_bit_for_bit_at_the_c4_heads_shapes(dev, dtype, c, h, w, form):
    with torch.inference_mode():
        args = case(c, h, w, form, dtype, dev, n=HEAD_ROWS, seed=c + h + form)
        got, want = _card_and_plain(args)
    _assert_bits(got, want, f"{FORMS[form]} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,c,h,w", [(1, 8, 1, 1), (1, 8, 3, 5), (3, 24, 7, 11),
                                     (1, 64, 1, 2113), (2, 1032, 5, 13), (1, 256, 529, 257),
                                     (5, 1024, 9, 1)])
def test_rows_no_multiple_of_the_stride(dev, dtype, n, c, h, w):
    """Row counts from 1 up, C from 8 (one vector a row) to 1032, where the
    grid's stride is no power of two and the last trip is ragged."""
    for form in range(3):
        args = case(c, h, w, form, dtype, dev, n=n, seed=form + c)
        got, want = _card_and_plain(args)
        _assert_bits(got, want, f"{FORMS[form]} {dtype} {(n, c, h, w)}")


@pytest.mark.cuda
def test_the_wrapper_refuses_what_it_does_not_take(dev):
    y, s, b = case(64, 4, 6, 0, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="channels-last"):
        frozen_bn_kernel.frozen_bn_relu_cuda(y.contiguous(), s, b)
    with pytest.raises(TypeError, match="float16"):
        frozen_bn_kernel.frozen_bn_relu_cuda(y.half(), s.half(), b.half())
    y12, s12, b12 = case(12, 4, 6, 0, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        frozen_bn_kernel.frozen_bn_relu_cuda(y12, s12, b12)
    with pytest.raises(ValueError, match="r: "):
        frozen_bn_kernel.frozen_bn_relu_cuda(y, s, b, y[:, :, :2])
    with pytest.raises(ValueError, match="s: "):
        frozen_bn_kernel.frozen_bn_relu_cuda(y, s.float(), b)
    with pytest.raises(ValueError, match="16 bytes"):
        frozen_bn_kernel.frozen_bn_relu_cuda(y, torch.empty(65, dtype=s.dtype, device=dev)[1:],
                                             b)


@pytest.mark.cuda
def test_trunk_call_on_the_card_is_the_plain_chain(dev, monkeypatch):
    """One bf16 ``ResNet50Trunk`` call of 4 images on the card: 40 launches
    (the stem and three a block), and the features of the plain chain on the
    card, bit for bit (cuDNN held to deterministic algorithms)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    trunk = _randomize(resnet.ResNet50Trunk(dtype=torch.bfloat16), seed=8).to(dev)
    trunk = trunk.to(torch.bfloat16)
    x = 50 * torch.randn(CELL_BATCH, 224, 320, 3, device=dev,
                         generator=torch.Generator(dev).manual_seed(9))
    with torch.inference_mode():
        before = frozen_bn_kernel.LAUNCHES
        got = trunk(x)
        assert frozen_bn_kernel.LAUNCHES - before == 40
        monkeypatch.setattr(frozen_bn_kernel, "frozen_bn_relu_cuda",
                            frozen_bn.frozen_bn_relu_reference)
        want = trunk(x)
    _assert_bits(got, want, "trunk features")


@pytest.mark.cuda
def test_train_step_path_keeps_the_plain_ops_on_the_card(dev, monkeypatch):
    """Under autograd on the card the block launches nothing and its
    gradients are the parent's (cuDNN held to deterministic algorithms)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    grads = []
    for fwd in (lambda b, x: b(x), parent_block):
        block = _randomize(resnet.Bottleneck(32, 16, 2), seed=10).to(dev)
        x = torch.randn(2, 32, 12, 16, generator=torch.Generator().manual_seed(11)).to(dev)
        x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last).requires_grad_()
        before = frozen_bn_kernel.LAUNCHES
        out = fwd(block, x)
        assert frozen_bn_kernel.LAUNCHES == before
        out.float().square().sum().backward()
        grads.append([out.detach(), x.grad] + [p.grad for p in block.parameters()])
    for got, want in zip(*grads):
        _assert_bits(got, want)
