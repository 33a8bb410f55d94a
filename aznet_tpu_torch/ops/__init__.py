"""Tensor ops: boxes, IoU, preprocessing, ROI align, NMS, top-k, losses."""

import torch


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would record through ``what``, a path the reference
    cannot differentiate either (a kernel with no backward, int8 rounding).
    Under ``torch.no_grad()``, or on tensors that need no gradient, it runs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no gradient: it is inference-only "
                           "(run it under torch.no_grad())")
