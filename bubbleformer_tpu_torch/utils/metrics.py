"""Physics metrics of a rollout.

Counterpart of ``bubbleformer_tpu/utils/metrics.py``: per-field relative L2
over time, the eikonal residual per step, vapor fraction and its drift (on
tensors, on their device), and the KL divergence of heat-flux
distributions (host side, scipy).
"""
from __future__ import annotations

import numpy as np
import torch

from bubbleformer_tpu_torch.utils.losses import eikonal_loss


def relative_l2_per_field(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``(T, C, H, W)`` predictions and targets -> ``(T, C)`` relative L2."""
    diff = torch.sqrt(((preds - targets) ** 2).sum(dim=(-2, -1)))
    norm = torch.sqrt((targets ** 2).sum(dim=(-2, -1)))
    return diff / norm


def eikonal_residual_per_step(phi: torch.Tensor, dx: float = 1.0 / 32.0) -> torch.Tensor:
    """``(T, H, W)`` SDF rollout -> ``(T,)`` eikonal residual per step."""
    return torch.stack([eikonal_loss(p, dx=dx) for p in phi])


def vapor_fraction(dfun: torch.Tensor) -> torch.Tensor:
    """Fraction of the domain occupied by vapor (``dfun > 0``) per frame."""
    return (dfun > 0).float().mean(dim=(-2, -1))


def mass_conservation_drift(pred_dfun: torch.Tensor, target_dfun: torch.Tensor) -> torch.Tensor:
    """Mean absolute difference in vapor fraction over a ``(T, H, W)`` rollout."""
    return (vapor_fraction(pred_dfun) - vapor_fraction(target_dfun)).abs().mean()


def heatflux_kl_divergence(sim_fluxes: np.ndarray, model_fluxes: np.ndarray,
                           num_points: int = 512) -> float:
    """KL(sim || model) between gaussian-KDE heat-flux PDFs, host side: a
    KDE fitted to each sample set, both evaluated on a common support
    padded by a tenth of its span, each normalised, ``p log(p / q)``
    integrated by Simpson's rule."""
    from scipy.integrate import simpson
    from scipy.stats import gaussian_kde

    sim_fluxes = np.asarray(sim_fluxes, dtype=np.float64)
    model_fluxes = np.asarray(model_fluxes, dtype=np.float64)
    if np.std(sim_fluxes) < 1e-12 or np.std(model_fluxes) < 1e-12:
        raise ValueError(
            "heat-flux samples are (near-)constant: the KDE is undefined; check that the "
            "heater geometry (dx, x_min) matches the data's domain")
    kde_sim, kde_model = gaussian_kde(sim_fluxes), gaussian_kde(model_fluxes)
    lo = min(sim_fluxes.min(), model_fluxes.min())
    hi = max(sim_fluxes.max(), model_fluxes.max())
    span = hi - lo if hi > lo else 1.0
    xs = np.linspace(lo - 0.1 * span, hi + 0.1 * span, num_points)
    p = np.maximum(kde_sim(xs), 1e-12)
    q = np.maximum(kde_model(xs), 1e-12)
    p = p / simpson(p, x=xs)
    q = q / simpson(q, x=xs)
    return float(simpson(p * np.log(p / q), x=xs))
