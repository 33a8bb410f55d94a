"""Wrappers of the hand-written CUDA kernels (sources in ``aznet_tpu_torch/csrc``)."""
