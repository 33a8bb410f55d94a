"""Wrappers of the hand-written CUDA kernels (sources in ``aznet_tpu_torch/csrc``)."""

import functools

import torch


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# The wrappers import sm_count from here.
from aznet_tpu_torch.ops.cuda import (conv1_kernel, conv_int8_kernel,  # noqa: E402
                                      frozen_bn_kernel, iou_kernel, nms_kernel,
                                      roi_align_kernel, search_level_kernel,
                                      search_select_kernel)

# Every launch counter the wrappers keep (one a call that reaches the card).
COUNTERS = {"nms": (nms_kernel, "LAUNCHES"), "roi_align": (roi_align_kernel, "LAUNCHES"),
            "conv1": (conv1_kernel, "LAUNCHES"), "conv1_f32": (conv1_kernel, "LAUNCHES_F32"),
            "chain": (conv_int8_kernel, "LAUNCHES_CHAIN"),
            "strip": (conv_int8_kernel, "LAUNCHES_STRIP"), "iou": (iou_kernel, "LAUNCHES"),
            "search_level": (search_level_kernel, "LAUNCHES"),
            "search_select": (search_select_kernel, "LAUNCHES"),
            "frozen_bn": (frozen_bn_kernel, "LAUNCHES"),
            "roi_align_levels": (roi_align_kernel, "LAUNCHES_LEVELS")}


# Active ``kernels.recording`` contexts: while any is, a forward that a CUDA
# graph would replay runs as it is (``utils/cuda_graph.py``), so that each
# launch passes through its wrapper.
RECORDING = 0


def launch_counts() -> dict[str, int]:
    """Every counter of :data:`COUNTERS` as it stands."""
    return {name: getattr(*owner) for name, owner in COUNTERS.items()}


def set_launch_counts(counts: dict[str, int] | None = None) -> None:
    """Sets the counters named in ``counts`` to its values; with no
    ``counts``, every counter to 0."""
    for name, n in (dict.fromkeys(COUNTERS, 0) if counts is None else counts).items():
        setattr(*COUNTERS[name], n)
