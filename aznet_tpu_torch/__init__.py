"""aznet_tpu_torch — the PyTorch/CUDA port of ``aznet_tpu`` for NVIDIA Hopper.

Mirrors ``aznet_tpu``'s layout (``aznet_tpu/X/y.py`` -> ``aznet_tpu_torch/X/y.py``)
and accepts the same ``aznet_tpu.config.Config``. Imports torch and numpy,
never JAX. Implemented so far: the float (bf16/f32) VGG-16 / smallnet
propose path (``api.im_propose``, ``api.make_propose_batch``), whose exact
greedy NMS runs as a CUDA kernel (``csrc/nms.cu``) on CUDA tensors and as
its plain PyTorch version on CPU tensors.
"""

__version__ = "0.1.0"
