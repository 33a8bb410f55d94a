"""``jax.lax.top_k`` semantics in PyTorch: the one top-k of the port.

``jax.lax.top_k`` orders by the float TOTAL order (+0 above -0, subnormals
kept apart) and returns the LOWER index first on ties; ``torch.topk``
promises no tie order, and a float sort treats -0 and +0 as equal. The
search relies on the tie order in three places (frontier eviction, where
the five children of one parent share a priority; the CAND_BUF cap;
``nms_topk``), so every top-k in the port goes through this helper: a
stable descending sort on the integer image of the float total order.
"""

from __future__ import annotations

import torch


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys, ascending in the float32 total order (NaN-free input)."""
    if x.dtype != torch.float32:
        raise TypeError(f"top_k takes float32, got {x.dtype}")
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)


def top_k(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest entries along the last axis,
    descending, ties to the lower index (as ``jax.lax.top_k``)."""
    _, idx = torch.sort(_total_order_key(x), dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx
