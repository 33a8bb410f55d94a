"""Training losses (``aznet_tpu/ops/losses.py``): Caffe's SmoothL1 with inside
and outside weights, sigmoid cross-entropy and softmax cross-entropy.

The same elementwise formulas as the reference, with the subgradients
``jax.grad`` takes: ``|x|`` has gradient 1 at +-0 (JAX's ``abs`` selects on
``x >= 0``; torch's ``abs`` would give 0 there, so :func:`_abs` writes it
out), and ``maximum(x, 0)`` splits its gradient in half at 0 in both
frameworks.
"""

from __future__ import annotations

import torch


def _abs(x):
    return torch.where(x >= 0, x, -x)


def smooth_l1_loss(pred, target, inside_weights=None, outside_weights=None,
                   sigma: float = 1.0):
    """``sum(outside * (0.5 * (sigma * d)**2 if |d| < 1 / sigma**2 else |d| -
    0.5 / sigma**2))`` with ``d = inside * (pred - target)``."""
    d = pred - target
    if inside_weights is not None:
        d = d * inside_weights
    s2 = sigma * sigma
    abs_d = _abs(d)
    loss = torch.where(abs_d < 1.0 / s2, 0.5 * s2 * d * d, abs_d - 0.5 / s2)
    if outside_weights is not None:
        loss = loss * outside_weights
    return loss.sum()


def _weighted(per, weights, total):
    den = weights.sum()
    if total is not None:
        den = total(den)
    return (per * weights).sum() / torch.clamp(den, min=1.0)


def sigmoid_ce_loss(logits, labels, weights=None, total=None):
    """Sigmoid cross-entropy in the log1p form, the mean over elements, or
    ``sum(per * weights) / max(sum(weights), 1)``. ``total`` maps the local
    sum of the weights to the batch-wide one before the clamp (the sum over
    the data-parallel ranks; ``train/train_az.py``), so that each rank's
    loss is its share of the global loss."""
    per = (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
           + torch.log1p(torch.exp(-_abs(logits))))
    if weights is None:
        return per.mean()
    return _weighted(per, weights, total)


def softmax_ce_loss(logits, labels, weights=None, total=None):
    """Softmax cross-entropy with integer ``labels``, weighted as
    :func:`sigmoid_ce_loss`."""
    logp = torch.log_softmax(logits, dim=-1)
    per = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if weights is None:
        return per.mean()
    return _weighted(per, weights, total)
