"""Physics metrics of a rollout: the parts ``scripts/inference_torch.py`` uses.

Counterpart of ``bubbleformer_tpu/utils/metrics.py`` (eikonal residual per
step, vapor fraction and its drift).
"""
from __future__ import annotations

import torch

from bubbleformer_tpu_torch.utils.losses import eikonal_loss


def eikonal_residual_per_step(phi: torch.Tensor, dx: float = 1.0 / 32.0) -> torch.Tensor:
    """``(T, H, W)`` SDF rollout -> ``(T,)`` eikonal residual per step."""
    return torch.stack([eikonal_loss(p, dx=dx) for p in phi])


def vapor_fraction(dfun: torch.Tensor) -> torch.Tensor:
    """Fraction of the domain occupied by vapor (``dfun > 0``) per frame."""
    return (dfun > 0).float().mean(dim=(-2, -1))


def mass_conservation_drift(pred_dfun: torch.Tensor, target_dfun: torch.Tensor) -> torch.Tensor:
    """Mean absolute difference in vapor fraction over a ``(T, H, W)`` rollout."""
    return (vapor_fraction(pred_dfun) - vapor_fraction(target_dfun)).abs().mean()
