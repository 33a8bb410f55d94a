"""Wrappers of the hand-written CUDA kernels (sources in ``aznet_tpu_torch/csrc``)."""

import functools

import torch


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
