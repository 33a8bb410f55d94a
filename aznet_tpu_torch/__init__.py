"""aznet_tpu_torch — the PyTorch/CUDA port of ``aznet_tpu`` for NVIDIA Hopper.

Mirrors ``aznet_tpu``'s layout (``aznet_tpu/X/y.py`` -> ``aznet_tpu_torch/X/y.py``)
and has its own copy of the config tree (``aznet_tpu_torch.config``, the
same fields and defaults). Imports torch and numpy, never JAX nor
``aznet_tpu``. Implemented so far: the float (bf16/f32) VGG-16 / smallnet
propose path, the int8 VGG-16 propose path (``api.im_propose``,
``api.make_propose_batch``; calibration in ``ops.quant``) and the detection
path (``api.im_detect``, ``api.make_detect_batch(_padded)``,
``api.make_fused_detect_batch_padded``). Nets are built on the card unless
``device="cpu"`` is passed. Four hand-written CUDA kernels run on CUDA
tensors, each with a plain PyTorch version for CPU tensors: exact greedy
NMS (``csrc/nms.cu``), the int8 3x3 conv with its fused pool
(``csrc/conv_int8.cu``), the fused ROI align (``csrc/roi_align.cu``) and the
fused conv1_2 + ReLU + pool1 (``csrc/conv1_fused.cu``).
"""

__version__ = "0.1.0"
