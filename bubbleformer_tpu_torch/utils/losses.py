"""Relative Lp loss and the eikonal SDF residual.

Counterpart of ``bubbleformer_tpu/utils/losses.py``.  Training uses
``LpLoss(d=2, p=2, reduce_dims=[0, 1, 2], reductions=["mean", "mean", "sum"])``
(``training/module.py``), inference ``LpLoss(d=2, p=2, reduce_dims=[0, 1],
reductions=["mean", "mean"])``.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import torch

from bubbleformer_tpu_torch.layers.norm import accumulation_dtype


def _gradient_1d(x: torch.Tensor, spacing: float, dim: int) -> torch.Tensor:
    """Central differences with first-order one-sided edges (torch.gradient's
    ``edge_order=1``)."""
    x = x.movedim(dim, -1)
    interior = (x[..., 2:] - x[..., :-2]) / (2.0 * spacing)
    lo = (x[..., 1:2] - x[..., 0:1]) / spacing
    hi = (x[..., -1:] - x[..., -2:-1]) / spacing
    return torch.cat([lo, interior, hi], dim=-1).movedim(-1, dim)


def eikonal_loss(phi: torch.Tensor, dx: float = 1.0 / 32.0) -> torch.Tensor:
    """``mean((|grad phi| - 1)^2)`` over a ``(..., H, W)`` SDF field."""
    gy = _gradient_1d(phi, dx, -2)
    gx = _gradient_1d(phi, dx, -1)
    return ((torch.sqrt(gy**2 + gx**2) - 1.0) ** 2).mean()


class LpLoss:
    """Relative Lp loss on ``(b, n1, ..., nd)``: the p-norm of the difference
    over the last ``d`` dims relative to the target's, then one reduction per
    listed leading dim."""

    def __init__(self, d: int = 1, p: int = 2, reduce_dims: Union[int, Sequence[int]] = 0,
                 reductions: Union[str, Sequence[str]] = "sum"):
        self.d = d
        self.p = p
        self.reduce_dims = [reduce_dims] if isinstance(reduce_dims, int) else list(reduce_dims)
        if isinstance(reductions, str):
            reductions = [reductions] * len(self.reduce_dims)
        for r in reductions:
            if r not in ("sum", "mean"):
                raise ValueError(f"reduction must be 'sum' or 'mean', got {r!r}")
        self.reductions: List[str] = list(reductions)

    def __call__(self, y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        acc = accumulation_dtype(y_pred.dtype)
        flat_pred = y_pred.reshape(*y_pred.shape[: -self.d], -1).to(acc)
        flat_y = y.reshape(*y.shape[: -self.d], -1).to(acc)
        diff = flat_pred - flat_y
        if self.p == 2:
            diff_norm = torch.sqrt((diff * diff).sum(-1))
            ynorm = torch.sqrt((flat_y * flat_y).sum(-1))
        else:
            diff_norm = (diff.abs() ** self.p).sum(-1) ** (1.0 / self.p)
            ynorm = (flat_y.abs() ** self.p).sum(-1) ** (1.0 / self.p)
        out = diff_norm / ynorm
        for dim, red in zip(self.reduce_dims, self.reductions):
            out = out.sum(dim, keepdim=True) if red == "sum" else out.mean(dim, keepdim=True)
        return out.squeeze()
