"""Heater heat-flux physics metric.

The port's own copy of ``bubbleformer_tpu/utils/heatflux.py``: FC-72 wall
heat flux ``q = 0.054 * (T_heater - T) / (dx * lc)`` with dx = 1/32 and
lc = 7e-4, over the heater's extent x in [-5, 5] and the liquid phase
(``dfun < 0``) of the wall row, averaged along it.  :func:`heatflux_series`
and :func:`heatflux` are numpy (host side, float64 sums);
:func:`heatflux_torch`, the counterpart of ``heatflux_jax``, runs on the
tensors' device in float32.
"""
from __future__ import annotations

import numpy as np
import torch

LC = 0.0007  # FC-72's characteristic length (m)


def _heater_mask(nx: int = 512, dx: float = 1.0 / 32.0, x_min: float = -8.0) -> np.ndarray:
    x_centers = x_min + (np.arange(nx) + 0.5) * dx
    return (x_centers >= -5.0) & (x_centers <= 5.0)


def heatflux_series(dfun: np.ndarray, temp: np.ndarray, heater_temp: float,
                    dx: float = 1.0 / 32.0, x_min: float = -8.0) -> np.ndarray:
    """Per-frame wall-averaged heat flux ``(T,)`` of ``(T, H, W)`` fields;
    the samples of the heat-flux distribution comparison
    (:func:`~bubbleformer_tpu_torch.utils.metrics.heatflux_kl_divergence`)."""
    mask_row = _heater_mask(nx=dfun.shape[-1], dx=dx, x_min=x_min)
    heater_mask = np.broadcast_to(mask_row[None, None, :], dfun.shape)
    temp_fields = (heater_mask & (dfun < 0)).astype(np.float64) * (heater_temp - temp)
    hflux_fields = 0.054 * (temp_fields / (dx * LC))
    return hflux_fields[:, 0, :].mean(axis=1)


def heatflux(dfun: np.ndarray, temp: np.ndarray, heater_temp: float, dx: float = 1.0 / 32.0,
             x_min: float = -8.0):
    """Mean and max wall heat flux over time of ``(T, H, W)`` fields; the
    defaults are the 512-grid FC-72 geometry (pass ``dx``/``x_min`` for
    other domains)."""
    hfluxes = heatflux_series(dfun, temp, heater_temp, dx=dx, x_min=x_min)
    return float(np.mean(hfluxes)), float(np.max(hfluxes))


def heatflux_torch(dfun: torch.Tensor, temp: torch.Tensor, heater_temp: float,
                   dx: float = 1.0 / 32.0, x_min: float = -8.0):
    """:func:`heatflux` on tensors, on their device, in float32: ``(mean,
    max)`` as 0-d tensors."""
    mask_row = torch.from_numpy(_heater_mask(nx=dfun.shape[-1], dx=dx, x_min=x_min)).to(
        dfun.device)
    wall = mask_row & (dfun[:, 0, :] < 0)  # only the wall row enters the mean
    temp_fields = wall.float() * (heater_temp - temp[:, 0, :].float())
    hfluxes = (0.054 * (temp_fields / (dx * LC))).mean(dim=1)
    return hfluxes.mean(), hfluxes.max()
