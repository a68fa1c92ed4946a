"""Learning-rate schedules as functions of the step.

Counterpart of ``bubbleformer_tpu/utils/schedulers.py`` with the same
semantics (torch's ``CosineWarmupLR``: a linear warmup LambdaLR, then
CosineAnnealingLR whose counter restarts at the ``warmup_iters`` milestone):

* warmup: ``lr = base * t / warmup_iters`` for ``t < warmup_iters``, so
  ``lr(0) = 0``;
* cosine phase: ``lr = eta_min + (base - eta_min) * (1 + cos(pi * (t -
  warmup_iters) / max_iters)) / 2``.

``t`` counts the optimizer updates already made, as optax's schedules do.
"""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def cosine_annealing(base_lr: float, t_max: int, eta_min: float = 0.0) -> Schedule:
    """torch ``CosineAnnealingLR(T_max=t_max, eta_min)``, stepped per update."""

    def schedule(step: int) -> float:
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * step / t_max))

    return schedule


def cosine_warmup(base_lr: float, warmup_iters: int, max_iters: int,
                  eta_min: float = 0.0) -> Schedule:
    """Linear warmup to ``base_lr``, then cosine annealing over ``max_iters``."""

    def schedule(step: int) -> float:
        if step < warmup_iters:
            return base_lr * step / max(warmup_iters, 1)
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * (step - warmup_iters) / max_iters))

    return schedule


def make_schedule(name: str, base_lr: float, total_steps: int, **params) -> Schedule:
    """Schedule keyed like the ``scheduler_cfg`` group."""
    if name == "cosine":
        return cosine_annealing(base_lr, t_max=total_steps, eta_min=params.get("eta_min", 0.0))
    if name == "cosine_warmup":
        return cosine_warmup(base_lr, warmup_iters=params.get("warmup_iters", 1000),
                             max_iters=total_steps, eta_min=params.get("eta_min", 0.0))
    if name == "constant":
        return lambda step: base_lr
    raise ValueError(f"Scheduler {name} not supported")
