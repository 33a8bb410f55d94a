"""ROI heads: fc6/fc7 plus the AZ outputs or the Fast R-CNN outputs
(``aznet_tpu/models/heads.py``: ``_FCStack``, its int8 stack,
``_fused_heads``, ``AZHead`` and ``FRCNNHead``), and, for the C4 detector
(``resnet101_c4``, which the JAX package lacks), ResNet's conv5_x on each
roi in fc6/fc7's place (:class:`Conv5Stack`).

Layer names match the reference's parameter tree (``fc.fc6``, ``fc.fc7``,
``zoom_score``, ``adj_score``, ``adj_bbox``; ``cls_score``, ``bbox_pred``) so
converted weights load 1:1.

fc6 and fc7 compute in ``dtype`` (weights, bias and input cast inside
``forward``; a no-op on an inference net, whose weights are cast already, and
the way gradients reach a training net's float32 masters). Inference
(``train=False``): no dropout, and ONE f32 dot against the concatenated
output layers as stored. Training (``train=True``): dropout after fc6 and
fc7 at ``dropout``, its masks drawn from an explicit ``torch.Generator``, and
the output layers as separate f32 dots on the f32 masters, as the
reference's ``train=True`` branch. Rows are independent, so the rois of
several images may go through as one batch.

Under a mesh (``parallel/mesh.py::shard_module`` sets ``FCStack.mesh``),
fc6 and fc7 are column-parallel over ``model``: each rank holds its rows of
the weight and the bias, its input goes through :class:`CopyToModel`
(identity forward, all-reduce over ``model`` backward) and its output
through :class:`GatherFromModel` (all-gather of the features forward, this
rank's slice backward: what follows the gather is replicated within the
model group). Dropout follows the gather, and draws the mask of the whole
global batch (``data`` x its rows) from the one generator, keeping this
rank's rows: the single-process mask.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aznet_tpu_torch.models.resnet import add_stage
from aznet_tpu_torch.ops import refuse_grad
from aznet_tpu_torch.ops.conv_int8 import (int8_matmul, quantize_acts, quantize_columns,
                                           scalar_f32)
from aznet_tpu_torch.parallel.mesh import all_gather, all_reduce
from aznet_tpu_torch.utils import profiling
from aznet_tpu_torch.utils.precision import float32_precision


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            rows=(0, 1)) -> torch.Tensor:
    """Flax's ``nn.Dropout``: ``where(mask, x / keep, 0)`` with ``mask ~
    Bernoulli(keep)`` from ``generator``; ``x`` unchanged at rate 0.
    ``rows = (i, n)``: ``x`` is part ``i`` of ``n`` equal row blocks of a
    batch whose mask is drawn whole."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    i, n = rows
    mask = torch.empty((n * x.shape[0],) + x.shape[1:], device=x.device).bernoulli_(
        keep, generator=generator)[i * x.shape[0]:(i + 1) * x.shape[0]]
    return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class CopyToModel(torch.autograd.Function):
    """Identity forward; backward, the sum of the input's gradient over the
    ``model`` group (each rank's rows of a column-parallel layer send back
    their part of dL/dx)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


class GatherFromModel(torch.autograd.Function):
    """Forward, the ``model`` group's outputs concatenated along the last
    dim; backward, this rank's slice of the gradient (the code after the
    gather is replicated within the group, so every rank holds the whole
    gradient: a reduce-scatter would scale it by the group's size)."""

    @staticmethod
    def forward(ctx, y, group, rank):
        ctx.rank, ctx.cols = rank, y.shape[-1]
        return all_gather(y, group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.rank * ctx.cols, ctx.cols), None, None


class FCStack(nn.Module):
    """fc6 -> ReLU -> fc7 -> ReLU on flattened NHWC pooled features.

    ``int8_scales = (s_in, s_mid)`` selects the reference's int8 stack: the
    pooled features quantize at ``s_in`` (or arrive as int8 at ``s_in`` from
    the int8 ROI align), fc6's output at ``s_mid``; each GEMM accumulates in
    int32 and dequantizes as ``acc * (s_x * s_w) + bias``; fc7 exits in bf16.
    The weights are quantized per output column ONCE, by :meth:`prepare_int8`,
    from the parameters as they are then (bf16-rounded in int8 mode, as the
    reference quantizes the already-cast tree). Training skips the int8
    stack, as the reference's. ``dtype`` None computes in the weights'
    dtype."""

    def __init__(self, in_dim: int, fc_dim: int = 4096, fc7_dim: int = 0,
                 int8_scales: tuple = (), dropout: float = 0.0, dtype=None):
        super().__init__()
        self.fc6 = nn.Linear(in_dim, fc_dim)
        self.fc7 = nn.Linear(fc_dim, fc7_dim or fc_dim)
        self.int8_scales = tuple(int8_scales)
        self.dropout = dropout
        self.dtype = dtype
        self._int8 = None
        self.mesh = None  # set by parallel/mesh.py::shard_module

    def prepare_int8(self) -> None:
        self._int8 = {name: (*quantize_columns(fc.weight.detach()), fc.bias.detach().float())
                      for name, fc in (("fc6", self.fc6), ("fc7", self.fc7))}

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        if self.int8_scales and not train:
            return self._int8_stack(x)
        if x.dtype == torch.int8:
            raise ValueError("int8 pooled features reached a non-int8 head "
                             "(missing INT8_HEAD_SCALES, or train=True)")
        dt = self.dtype or self.fc6.weight.dtype
        x = x.to(dt)
        mesh = self.mesh
        rows = (0, 1) if mesh is None else (mesh.coords["data"], mesh.shape["data"])
        with float32_precision():
            for fc in (self.fc6, self.fc7):
                if mesh is not None:
                    x = CopyToModel.apply(x, mesh.group("model"))
                # The module itself when no cast is needed: forward hooks fire.
                y = fc(x) if fc.weight.dtype == dt else F.linear(x, fc.weight.to(dt),
                                                                  fc.bias.to(dt))
                if mesh is not None:
                    y = GatherFromModel.apply(y, mesh.group("model"), mesh.coords["model"])
                x = F.relu(y)
                if train:
                    x = dropout(x, self.dropout, generator, rows)
        return x

    def _int8_stack(self, x: torch.Tensor) -> torch.Tensor:
        if self._int8 is None:
            raise RuntimeError("int8 fc weights are not quantized: call prepare_int8()")
        s_in, s_mid = self.int8_scales

        def dense(x8, s_x, name):
            wq, s_w, bias = self._int8[name]
            acc = int8_matmul(x8, wq)
            return torch.relu(acc.float() * (scalar_f32(s_x, x8.device) * s_w) + bias)

        refuse_grad("the int8 fc stack", x)
        if self.mesh is not None:
            raise NotImplementedError("the int8 fc stack does not run sharded over a mesh")
        x8 = x if x.dtype == torch.int8 else quantize_acts(x, s_in)
        h8 = quantize_acts(dense(x8, s_in, "fc6"), s_mid)
        return dense(h8, s_mid, "fc7").to(torch.bfloat16)


class Conv5Stack(nn.Module):
    """The C4 detector's stack in fc6/fc7's place (He et al.,
    arXiv:1512.03385, Appendix A): ResNet's conv5_x on each pooled roi, then
    the mean over its spatial output. ``[R, P, P, C]`` NHWC pools (P = 14,
    C = 1024) -> ``[R, 2048]`` float32.

    Three bottlenecks (``layer4_block0`` to ``layer4_block2``: 512 wide
    inside, 2048 out), the first at stride 2 in its 3x3 conv with SAME
    padding and projected by a stride-2 1x1 (the trunk's convention; the
    MSRA Caffe models put the stride in the first 1x1), each conv followed
    by its frozen BatchNorm epilogue (``FrozenBN(..., relu=True)``: one
    launch on the card); then the mean over the 7x7 output, in float32.
    Computes in ``dtype`` (None: the weights' dtype), each weight cast
    inside ``forward``, as the trunk does; under autograd the epilogues take
    PyTorch's plain operations (``ops/frozen_bn.py``), and ``train=True``
    runs the same stack (no dropout).

    The rule of the config (no field of its own): the stack reads neither
    ``MODEL.FC_DIM`` nor ``MODEL.FC7_DIM``; its width is conv5_x's, and the
    output layers take 2048 inputs. It has no int8 form and does not run
    sharded over a mesh: ``models/aznet.py::check_supported`` refuses
    ``COMPUTE_DTYPE='int8'`` and ``INT8_HEAD_SCALES`` for its backbones, and
    a mesh (``parallel/mesh.py::shard_module`` sets :attr:`mesh`) with more
    than one rank on ``model`` raises; on ``data`` alone it stays replicated
    and runs as it is."""

    out_dim = 2048
    int8_scales = ()

    def __init__(self, in_channels: int = 1024, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.block_names, _ = add_stage(self, 3, 3, in_channels, 2)

    @property
    def mesh(self):
        return None

    @mesh.setter
    def mesh(self, value):
        if value is not None and value.shape["model"] > 1:
            raise NotImplementedError("backbone 'resnet101_c4': its conv5_x head does not run "
                                      "sharded over a mesh's model axis")

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        with profiling.span("heads.conv5", rows=x.shape[0]), float32_precision():
            x = x.to(self.dtype or self.layer4_block0.conv1.weight.dtype).permute(0, 3, 1, 2)
            for name in self.block_names:
                x = getattr(self, name)(x)
            return x.mean((2, 3), dtype=torch.float32)


@float32_precision()
def fused_heads(x: torch.Tensor, layers) -> torch.Tensor:
    """ONE f32 dot of fc7's output against the concatenated output layers,
    on the weights as stored (bf16-rounded in bf16 mode): the reference's
    ``_fused_heads``."""
    w = torch.cat([m.weight for m in layers]).float()
    b = torch.cat([m.bias for m in layers]).float()
    return x.float() @ w.t() + b


@float32_precision()
def separate_heads(x: torch.Tensor, layers) -> list:
    """The training branch: one f32 dot per output layer on its float32
    weights (the reference's f32 ``Dense`` layers on fc7's output)."""
    x = x.float()
    return [F.linear(x, m.weight.float(), m.bias.float()) for m in layers]


def feature_stack(in_dim: int, fc_dim: int, fc7_dim: int, int8_scales: tuple, dropout: float,
                  dtype, conv5: bool = False) -> tuple:
    """``(stack, out_dim)``: the head's features before the output layers.
    ``conv5``: :class:`Conv5Stack` (``in_dim`` the pools' channels);
    otherwise fc6/fc7, ``FCStack`` as this module holds it when the head is
    built (``in_dim`` the flattened pool)."""
    if conv5:
        return Conv5Stack(in_dim, dtype), Conv5Stack.out_dim
    return FCStack(in_dim, fc_dim, fc7_dim, int8_scales, dropout, dtype), fc7_dim or fc_dim


class AZHead(nn.Module):
    """``[R, P, P, C]`` pooled features -> ``zoom [R]``, ``adj_score [R, K]``
    (logits) and ``adj_delta [R, K, 4]``, all float32."""

    SCORE_STD = {"zoom_score": 0.01, "adj_score": 0.01, "adj_bbox": 0.001}

    def __init__(self, in_dim: int, num_templates: int = 11, fc_dim: int = 4096,
                 fc7_dim: int = 0, int8_scales: tuple = (), dropout: float = 0.0, dtype=None,
                 conv5: bool = False):
        super().__init__()
        self.num_templates = num_templates
        self.fc, d = feature_stack(in_dim, fc_dim, fc7_dim, int8_scales, dropout, dtype, conv5)
        self.zoom_score = nn.Linear(d, 1)
        self.adj_score = nn.Linear(d, num_templates)
        self.adj_bbox = nn.Linear(d, 4 * num_templates)

    def forward(self, pooled: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> dict:
        k = self.num_templates
        x = self.fc(pooled, train, generator)
        layers = (self.zoom_score, self.adj_score, self.adj_bbox)
        if train:
            zoom, adj, delta = separate_heads(x, layers)
        else:
            y = fused_heads(x, layers)
            zoom, adj, delta = y[:, 0:1], y[:, 1:1 + k], y[:, 1 + k:]
        return {"zoom": zoom[:, 0], "adj_score": adj, "adj_delta": delta.reshape(-1, k, 4)}


class FRCNNHead(nn.Module):
    """``[R, P, P, C]`` pooled features -> ``cls_score [R, K]`` (logits) and
    ``bbox_pred [R, 4K]``, float32, for K classes."""

    SCORE_STD = {"cls_score": 0.01, "bbox_pred": 0.001}

    def __init__(self, in_dim: int, num_classes: int = 21, fc_dim: int = 4096,
                 fc7_dim: int = 0, int8_scales: tuple = (), dropout: float = 0.0, dtype=None,
                 conv5: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.fc, d = feature_stack(in_dim, fc_dim, fc7_dim, int8_scales, dropout, dtype, conv5)
        self.cls_score = nn.Linear(d, num_classes)
        self.bbox_pred = nn.Linear(d, 4 * num_classes)

    def forward(self, pooled: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> dict:
        x = self.fc(pooled, train, generator)
        layers = (self.cls_score, self.bbox_pred)
        if train:
            cls, bbox = separate_heads(x, layers)
        else:
            y = fused_heads(x, layers)
            cls, bbox = y[:, :self.num_classes], y[:, self.num_classes:]
        return {"cls_score": cls, "bbox_pred": bbox}
