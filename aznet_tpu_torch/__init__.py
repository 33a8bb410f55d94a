"""aznet_tpu_torch — the PyTorch/CUDA port of ``aznet_tpu`` for NVIDIA Hopper.

Mirrors ``aznet_tpu``'s layout (``aznet_tpu/X/y.py`` -> ``aznet_tpu_torch/X/y.py``)
and accepts the same ``aznet_tpu.config.Config``. Imports torch and numpy,
never JAX. Implemented so far: the float (bf16/f32) VGG-16 / smallnet
propose path and the int8 VGG-16 propose path (``api.im_propose``,
``api.make_propose_batch``; calibration in ``ops.quant``). Two hand-written
CUDA kernels run on CUDA tensors, each with a plain PyTorch version for CPU
tensors: exact greedy NMS (``csrc/nms.cu``) and the int8 3x3 conv with its
fused pool (``csrc/conv_int8.cu``).
"""

__version__ = "0.1.0"
