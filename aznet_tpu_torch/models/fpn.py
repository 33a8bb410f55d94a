"""ResNet-101 with a Feature Pyramid Network (Lin et al., arXiv:1612.03144),
the trunk of Detectron's Faster R-CNN R-101-FPN
(``configs/12_2017_baselines/e2e_faster_rcnn_R-101-FPN_2x.yaml``):
``[B, H, W, 3]`` -> ``(P2, P3, P4, P5)``, each ``[B, H/s, W/s, 256]`` at
strides 4, 8, 16 and 32, finest first. The JAX package has no counterpart.

- Bottom up: ResNet-101's stem and stages, 3, 4, 23 and 3 bottlenecks
  (``models/resnet.py``: ``Bottleneck``, ``FrozenBN`` and its one-launch
  epilogue on the card), conv5_x (``layer4_block0`` to ``layer4_block2``)
  over the whole image at stride 32; the first block of conv3_x to conv5_x
  strides in its 3x3 conv with SAME padding, as the port's other ResNets.
  C2 to C5 are each stage's last output.
- The pathway: ``fpn_lateral{k}``, a 1x1 conv with bias from C_k to 256
  channels; top down from C5, the coarser sum upsampled 2x by nearest
  neighbour (to the lateral's size) and added to the lateral; then
  ``fpn_output{k}``, a 3x3 pad-1 conv with bias, on each sum: P_k. No
  BatchNorm or ReLU in the pathway. Detectron's P6 (a max pool of P5) feeds
  its RPN alone and is left out.

Each box pools from its own level (``ops/roi_pool.py::roi_pool_levels``,
``models/aznet.py::RoiNet.roi_pool_only``), so the head's input is 7 x 7 x
256 and ``MODEL.FEAT_STRIDE`` is not read. What the pyramid does not run
(AZ-Net's search head, int8, pooling other than ROI align, training, a mesh
split over ``model``) is refused, naming the backbone
(``models/aznet.py::check_supported``; :attr:`ResNet101FPNTrunk.mesh`,
which ``parallel/mesh.py::shard_module`` sets before it splits any
parameter; ``train/train_az.py::head_outputs``).

Computes in ``dtype`` (None: the weights' dtype), each weight cast inside
``forward``, as the other trunks; float32 convolutions run in true float32
(``utils/precision.py``). The pathway runs in a ``trunk.fpn`` span. On the
card in inference a shape's calls after its first replay a CUDA graph of the
whole trunk (``utils/cuda_graph.py``): the host queues one launch where it
queued some 220, as long as the card took to run them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aznet_tpu_torch.models.resnet import RESNET101_STAGE_SIZES, ResNet50Trunk
from aznet_tpu_torch.utils import profiling
from aznet_tpu_torch.utils.cuda_graph import ShapeGraphs
from aznet_tpu_torch.utils.precision import float32_precision

STAGE_SIZES = RESNET101_STAGE_SIZES + (3,)  # conv2_x .. conv5_x
FPN_DIM = 256
LEVELS = (2, 3, 4, 5)  # P2 .. P5, at stride 2 ** k


class ResNet101FPNTrunk(ResNet50Trunk):
    """``[B, H, W, 3]`` -> ``(P2, P3, P4, P5)`` NHWC ``[B, h_k, w_k, 256]``;
    H and W multiples of 32 (Detectron pads its images so) give every level
    exactly half the size of the one below."""

    level_strides = tuple(2 ** k for k in LEVELS)
    feat_stride = None  # one stride a level: level_strides
    out_channels = FPN_DIM

    def __init__(self, int8_mode: bool = False, int8_scales: tuple = (), dtype=None):
        super().__init__(int8_mode, int8_scales, dtype, STAGE_SIZES)
        self.stage_ends = [sum(STAGE_SIZES[:s + 1]) for s in range(len(STAGE_SIZES))]
        self.graphs = ShapeGraphs()
        for k, c in zip(LEVELS, (256, 512, 1024, 2048)):
            self.add_module(f"fpn_lateral{k}", nn.Conv2d(c, FPN_DIM, 1))
            self.add_module(f"fpn_output{k}", nn.Conv2d(FPN_DIM, FPN_DIM, 3, padding=1))

    @property
    def mesh(self):
        return None

    @mesh.setter
    def mesh(self, value):
        if value is not None and value.shape["model"] > 1:
            raise NotImplementedError("backbone 'resnet101_fpn': its feature pyramid does not "
                                      "run sharded over a mesh's model axis")

    def _conv(self, name: str, x: torch.Tensor, **kw) -> torch.Tensor:
        conv = getattr(self, name)
        return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), **kw)

    def forward(self, x: torch.Tensor) -> tuple:
        """On the card in inference, from a CUDA graph of :meth:`layers` for
        ``x``'s shape (``utils/cuda_graph.py``); otherwise :meth:`layers`."""
        return self.graphs(self.layers, x)

    def _apply(self, fn, *args, **kwargs):
        self.graphs = ShapeGraphs()  # they read the parameters where they were
        return super()._apply(fn, *args, **kwargs)

    @float32_precision()
    def layers(self, x: torch.Tensor) -> tuple:
        dt = self.dtype or self.conv1.weight.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = self.bn1(F.conv2d(x, self.conv1.weight.to(dt), stride=2, padding=3), relu=True)
        x = F.max_pool2d(x, 3, 2, padding=1)
        c = []
        for i, block in enumerate(self.blocks()):
            x = block(x)
            if i + 1 in self.stage_ends:
                c.append(x)
        with profiling.span("trunk.fpn"):
            top, levels = None, []
            for k, ck in zip(reversed(LEVELS), reversed(c)):
                lat = self._conv(f"fpn_lateral{k}", ck)
                top = lat if top is None else lat + F.interpolate(top, size=lat.shape[-2:],
                                                                  mode="nearest")
                levels.insert(0, self._conv(f"fpn_output{k}", top, padding=1))
            return tuple(p.permute(0, 2, 3, 1) for p in levels)
