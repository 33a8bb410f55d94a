"""SGD with momentum, weight decay and a step learning rate, the reference's
optax chain (``aznet_tpu/train/optim.py``) written out in its order:

1. zero the gradients of frozen parameters (``FREEZE_PREFIXES``: a name
   component starting with a prefix);
2. ``clip_by_global_norm(GRAD_CLIP)``: ``g / norm * GRAD_CLIP`` unless
   ``norm < GRAD_CLIP``;
3. decayed weights, ``g + WEIGHT_DECAY * p``, on every parameter but those
   named ``bias`` or ``scale`` (FrozenBN's included);
4. momentum, ``m = u + MOMENTUM * m``, and the update ``-lr * m`` with the
   staircase rate ``LEARNING_RATE * GAMMA ** floor(count / STEPSIZE)``,
   ``count`` being the number of earlier updates;
5. no update at all on frozen parameters, so weight decay never moves them.

Every operation rounds to float32 once, as optax's, so the two agree to
float32 rounding (the global norm sums in another order).
"""

from __future__ import annotations

import torch

from aznet_tpu_torch.config import TrainConfig


def lr_schedule(tcfg: TrainConfig):
    """``count -> lr`` as a float32 0-d tensor on the host, computed as
    ``optax.exponential_decay(staircase=True)`` computes it."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731

    def schedule(count: int) -> torch.Tensor:
        if count <= 0 or tcfg.STEPSIZE <= 0 or tcfg.GAMMA == 0:
            return f32(tcfg.LEARNING_RATE)
        p = torch.floor(f32(count) / f32(tcfg.STEPSIZE))
        return f32(tcfg.LEARNING_RATE) * torch.pow(f32(tcfg.GAMMA), p)

    return schedule


def decayed(name: str) -> bool:
    """Weight decay applies to every parameter but biases and scales."""
    return name.rsplit(".", 1)[-1] not in ("bias", "scale")


def frozen(name: str, prefixes) -> bool:
    """A component of the dotted parameter name starts with a prefix. (The
    reference matches its Flax path, whose leaves are ``kernel`` where the
    port's are ``weight``, under a ``params`` root.)"""
    return any(part.startswith(p) for part in name.split(".") for p in prefixes)


def global_norm(tensors, sharded=(), total=None) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all elements of ``tensors``, float32.
    ``sharded[i]`` marks a tensor split over ranks (fc6/fc7 under tensor
    parallelism): its sum of squares goes through ``total`` (the sum over
    the ``model`` group) and the replicated ones count once; the terms are
    added in the order of ``tensors`` either way."""
    sq = [(t.float() * t.float()).sum() for t in tensors]
    idx = [i for i, s in enumerate(sharded) if s]
    if idx:
        summed = total(torch.stack([sq[i] for i in idx]))
        for j, i in enumerate(idx):
            sq[i] = summed[j]
    return torch.sqrt(sum(sq))


class SGD:
    """The optimizer over ``params`` (``{name: Parameter}``, float32).
    ``state_dict()`` holds the momentum buffers and the update count.
    ``sharded`` names the parameters split over ranks and ``total`` sums
    over their group (:func:`global_norm`); each momentum buffer has its
    parameter's shape, so it is split as its parameter is."""

    def __init__(self, params: dict, tcfg: TrainConfig, sharded=(), total=None):
        self.tcfg = tcfg
        self.params = dict(params)
        self.momentum = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0
        self._frozen = {n for n in self.params if frozen(n, tcfg.FREEZE_PREFIXES)}
        self._schedule = lr_schedule(tcfg)
        self.sharded, self.total = frozenset(sharded), total

    def norm(self, grads: dict) -> torch.Tensor:
        """The global norm of ``grads`` (``{name: tensor or None}``)."""
        names = [n for n, t in grads.items() if t is not None]
        return global_norm([grads[n] for n in names], [n in self.sharded for n in names],
                           self.total)

    def step(self, grads: dict) -> None:
        """One update from ``grads`` (``{name: tensor or None}``; None is a
        zero gradient). One parameter at a time, in place where the rounding
        allows, so that the transient memory is one parameter's."""
        tcfg = self.tcfg
        dev = next(iter(self.params.values())).device
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        with torch.no_grad():
            g = {n: None if n in self._frozen else grads.get(n) for n in self.params}
            norm = clip = None
            if tcfg.GRAD_CLIP:
                norm = self.norm(g)
                clip = f32(tcfg.GRAD_CLIP)
            wd, mu = f32(tcfg.WEIGHT_DECAY), f32(tcfg.MOMENTUM)
            neg_lr = -self._schedule(self.count).to(dev)
            for n, p in self.params.items():
                t = g[n] if g[n] is not None else torch.zeros_like(p)
                if clip is not None:
                    t = torch.where(norm < clip, t, t / norm * clip)
                if tcfg.WEIGHT_DECAY and decayed(n):
                    t = (wd * p).add_(t)  # g + wd * p, each product and sum rounded once
                self.momentum[n].mul_(mu).add_(t)  # g + mu * m
                if n not in self._frozen:
                    p.add_(neg_lr * self.momentum[n])
        self.count += 1

    def state_dict(self) -> dict:
        return {"momentum": dict(self.momentum), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        for n, m in state["momentum"].items():
            self.momentum[n] = m.to(self.momentum[n].device, torch.float32).clone()
        self.count = int(state["count"])


def make_optimizer(tcfg: TrainConfig, params: dict) -> SGD:
    return SGD(params, tcfg)
