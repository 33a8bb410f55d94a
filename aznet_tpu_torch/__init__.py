"""aznet_tpu_torch — the PyTorch/CUDA port of ``aznet_tpu`` for NVIDIA Hopper.

Mirrors ``aznet_tpu``'s layout (``aznet_tpu/X/y.py`` -> ``aznet_tpu_torch/X/y.py``)
and has its own copy of the config tree (``aznet_tpu_torch.config``, the
same fields and defaults). Imports torch and numpy, never JAX nor
``aznet_tpu``. Implemented so far: the float (bf16/f32) propose path on
every trunk of the JAX package (VGG-16, ResNet-50, CaffeNet,
VGG_CNN_M_1024, smallnet), the int8 propose path on VGG-16 and ResNet-50
(``api.im_propose``, ``api.make_propose_batch``; calibration in
``ops.quant``) and the detection path (``api.im_detect``,
``api.make_detect_batch(_padded)``, ``api.make_fused_detect_batch_padded``).
Over image sets: the imdbs (``data/``: the factory, PASCAL VOC, COCO, the
synthetic planted-boxes imdb) and evaluation (``eval/``: proposal recall,
VOC and COCO AP, and the drivers ``propose_all(_batched)``,
``evaluate_recall``, ``detect_all(_batched)``, ``detect_all_fused``), with
``ops.quant.calibrate_net_on_imdb``. Training (``train/``: losses, SGD,
the AZ and Fast R-CNN train steps, labels, minibatches and the prefetch
workers, hard-region mining, snapshots, ``train.loop.train_az_net`` /
``train_frcnn_net``). The host side (per-class NMS, the
COCO matcher, image blobs) runs in a C++ host library built at first use
(``csrc/host.cc``, ``utils/native.py``). Nets are built on the card unless
``device="cpu"`` is passed. Five hand-written CUDA kernels run on CUDA
tensors, each with a plain PyTorch version for CPU tensors: exact greedy
NMS (``csrc/nms.cu``), the int8 3x3
conv with its fused pool (``csrc/conv_int8.cu``), the fused ROI align
(``csrc/roi_align.cu``), the fused conv1_2 + ReLU + pool1
(``csrc/conv1_fused.cu``) and the tiled IoU matrix (``csrc/iou.cu``, called
by no path, as its Pallas counterpart). ``entry`` holds the flagship
forward and the multi-device dry run (``__graft_entry__.py``'s
counterparts).
"""

__version__ = "0.1.0"
