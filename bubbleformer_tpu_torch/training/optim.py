"""Optimizers: Lion, AdamW and Adam with torch's semantics.

Counterpart of ``bubbleformer_tpu/training/optim.py`` (the reference's
dispatch, ``bubbleformer/modules.py:132-142``), per parameter tensor:

* ``adamw``: ``torch.optim.AdamW`` — weight decay decoupled, scaled by lr;
* ``adam``: ``torch.optim.Adam`` — weight decay added to the gradient before
  the moment updates;
* ``lion``: :class:`Lion` below, lion_pytorch's update (optax.lion's too):
  ``p <- p * (1 - lr * wd) - lr * sign(b1 * m + (1 - b1) * g)``, then
  ``m <- b2 * m + (1 - b2) * g``.

The JAX package's ``flatten_2d`` has no counterpart: it packed every
parameter into one buffer for the TPU's tiling.  The learning rate of each
update is set by the caller from the schedule (``training/module.py``).
"""
from __future__ import annotations

from typing import Iterable, Tuple

import torch


class Lion(torch.optim.Optimizer):
    """Lion (Chen et al. 2023) over ``_foreach`` ops, one update per tensor."""

    def __init__(self, params: Iterable, lr: float = 1e-4,
                 betas: Tuple[float, float] = (0.9, 0.99), weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p]["exp_avg"] = torch.zeros_like(p)
            exp_avgs = [self.state[p]["exp_avg"] for p in params]
            lr, wd = group["lr"], group["weight_decay"]
            b1, b2 = group["betas"]
            if wd:
                torch._foreach_mul_(params, 1.0 - lr * wd)
            update = torch._foreach_mul(exp_avgs, b1)
            torch._foreach_add_(update, grads, alpha=1.0 - b1)
            torch._foreach_sign_(update)
            torch._foreach_add_(params, update, alpha=-lr)
            torch._foreach_mul_(exp_avgs, b2)
            torch._foreach_add_(exp_avgs, grads, alpha=1.0 - b2)
        return loss


def make_optimizer(name: str, params: Iterable, lr: float = 0.0,
                   **kw) -> torch.optim.Optimizer:
    """The optimizer of an ``optim_cfg`` group (``weight_decay``, ``b1``,
    ``b2``, ``eps`` as in the JAX package's factory)."""
    wd = kw.get("weight_decay", 0.0)
    if name in ("adamw", "adam"):
        cls = torch.optim.AdamW if name == "adamw" else torch.optim.Adam
        return cls(params, lr=lr, betas=(kw.get("b1", 0.9), kw.get("b2", 0.999)),
                   eps=kw.get("eps", 1e-8), weight_decay=wd, foreach=True)
    if name == "lion":
        return Lion(params, lr=lr, betas=(kw.get("b1", 0.9), kw.get("b2", 0.99)),
                    weight_decay=wd)
    raise ValueError(f"Optimizer {name} not supported")
