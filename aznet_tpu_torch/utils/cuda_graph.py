"""A forward pass replayed from a CUDA graph, one graph an input shape.

The host queues the R-101-FPN trunk's some 220 launches a call (cuDNN's
convolutions, the frozen BatchNorm epilogues, the pathway) in about the time
the card takes to run them, so a call's time follows the host's speed from
run to run. A graph queues them as one launch. :class:`ShapeGraphs` keeps
the graphs of a module's forward:

- it replays only on CUDA with autograd not recording, outside another
  capture, and while no ``kernels.recording`` is active
  (``ops.cuda.RECORDING``); otherwise the forward runs as it is, so that each
  launch passes through its wrapper;
- a shape's first call runs as it is and its second captures it (a pass on a
  side stream first, which builds cuDNN's plans, then the capture), for at
  most :data:`MAX_SHAPES` shapes: a canvas seen once stays uncaptured;
- a replay adds to the launch counters what the captured pass added
  (``ops.cuda.COUNTERS``), so they read as they do without the graph;
- what a replay returns is copied out of the graph's buffers, so a caller
  may keep a call's outputs across calls;
- a graph reads the parameters at the addresses they had when it was
  captured: the module drops its graphs where they move (its ``_apply``,
  which a cast or a move to another device calls); weights loaded in place
  (``load_state_dict``) are read by the next replay.

The captured kernels are the forward's own, so a replay returns the same
bits as the forward (``tests/test_torch_resnet101_fpn.py``'s card tests).
"""

from __future__ import annotations

import collections

import torch

from aznet_tpu_torch.ops import cuda as cuda_ops

MAX_SHAPES = 4  # graphs kept by one forward, each with its own memory pool


def replayable(x: torch.Tensor) -> bool:
    """Whether a call on ``x`` may capture or replay a graph."""
    return (x.is_cuda and not torch.is_grad_enabled() and not cuda_ops.RECORDING
            and not torch.cuda.is_current_stream_capturing())


class ShapeGraphs:
    """The graphs of one forward, by input shape, dtype and device."""

    def __init__(self):
        self.seen = collections.Counter()
        self.graphs = {}  # key -> (graph, static input, static outputs, launches a replay)

    def __call__(self, forward, x: torch.Tensor) -> tuple:
        """``forward(x)``, a tuple of tensors, from a graph where one is kept
        or due for ``x``'s shape."""
        if not replayable(x):
            return forward(x)
        key = (tuple(x.shape), x.dtype, x.device)
        kept = self.graphs.get(key)
        if kept is None:
            self.seen[key] += 1
            if self.seen[key] < 2 or len(self.graphs) >= MAX_SHAPES:
                return forward(x)
            kept = self.graphs[key] = self._capture(forward, x)
        graph, static_in, static_out, launched = kept
        static_in.copy_(x)
        graph.replay()
        counts = cuda_ops.launch_counts()
        cuda_ops.set_launch_counts({k: counts[k] + n for k, n in launched.items()})
        return tuple(t.clone() for t in static_out)

    @staticmethod
    def _capture(forward, x: torch.Tensor) -> tuple:
        before = cuda_ops.launch_counts()
        static_in = x.clone()
        with torch.cuda.device(x.device):
            side, main = torch.cuda.Stream(), torch.cuda.current_stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                forward(static_in)
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            warm = cuda_ops.launch_counts()
            with torch.cuda.graph(graph):
                static_out = forward(static_in)
        after = cuda_ops.launch_counts()
        cuda_ops.set_launch_counts(before)
        launched = {k: after[k] - warm[k] for k in after if after[k] != warm[k]}
        return graph, static_in, tuple(static_out), launched
