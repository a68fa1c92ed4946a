"""Autoregressive rollout that stays on the device.

Counterpart of ``bubbleformer_tpu/inference/rollout.py``: each window's
prediction is fed back as the next input; the JAX package's ``lax.scan``
becomes a Python loop over windows whose carry never leaves the device, cast
back to the window dtype each step.  The model holds its weights, so the
rollout functions take no ``variables``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from bubbleformer_tpu_torch.utils.losses import eikonal_loss


def make_rollout_fn(model, num_windows: int, conditioned: bool = False) -> Callable:
    """``fn(init_window[, cond]) -> (num_windows, B, T, C, H, W)``.

    The first prediction consumes ``init_window``; each later window consumes
    the previous prediction.  Output fields must equal input fields."""

    @torch.no_grad()
    def rollout(init_window: torch.Tensor, cond: Optional[torch.Tensor] = None):
        if conditioned and cond is None:
            raise ValueError("conditioned rollout needs cond")
        window = init_window
        preds = []
        for _ in range(num_windows):
            pred = model(window, cond) if conditioned else model(window)
            window = pred.to(window.dtype)  # keep the carry dtype under bf16 compute
            preds.append(window)
        return torch.stack(preds)

    return rollout


def window_relative_l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Relative L2 of each ``(H, W)`` plane of ``(B, T, C, H, W)`` windows,
    in float32, averaged over the batch: ``(T, C)``.  The window metric of
    both modes of ``scripts/inference_torch.py``, so the in-scan and the
    post-hoc lines come from one arithmetic."""
    diff = torch.sqrt(((pred - target).float() ** 2).sum(dim=(-2, -1)))
    norm = torch.sqrt((target.float() ** 2).sum(dim=(-2, -1)))
    return (diff / norm).mean(dim=0)


def make_rollout_metrics_fn(model, num_windows: int, dfun_index: Optional[int] = None,
                            dx: float = 1.0 / 32.0, conditioned: bool = False) -> Callable:
    """Rollout that reduces each window to its metrics as it goes and keeps
    no stack of predictions (``scripts/inference_torch.py --in-scan-metrics``).

    ``fn(init_window, targets=None, cond=None) -> dict`` with ``rel_l2``
    ``(num_windows, T, C)`` (when ``targets`` ``(num_windows, B, T, C, H, W)``
    is given), ``eikonal`` and ``vapor_fraction`` ``(num_windows, T)`` (when
    ``dfun_index`` is set), ``vapor_drift`` (both) and ``final_window``."""

    def window_metrics(pred, target):
        ys = {}
        if target is not None:
            ys["rel_l2"] = window_relative_l2(pred, target)
        if dfun_index is not None:
            phi = pred[:, :, dfun_index]
            ys["eikonal"] = torch.stack(
                [torch.stack([eikonal_loss(p, dx=dx) for p in seq]) for seq in phi]
            ).mean(dim=0)
            vf = (phi > 0).float().mean(dim=(-2, -1))
            ys["vapor_fraction"] = vf.mean(dim=0)
            if target is not None:
                vft = (target[:, :, dfun_index] > 0).float().mean(dim=(-2, -1))
                ys["vapor_drift"] = (vf - vft).abs().mean(dim=0)
        return ys

    @torch.no_grad()
    def rollout(init_window: torch.Tensor, targets: Optional[torch.Tensor] = None,
                cond: Optional[torch.Tensor] = None):
        if targets is not None and targets.shape[0] != num_windows:
            raise ValueError(
                f"targets leading dim {targets.shape[0]} != num_windows {num_windows}"
            )
        window = init_window
        per_window = []
        for k in range(num_windows):
            pred = model(window, cond) if conditioned else model(window)
            window = pred.to(window.dtype)
            per_window.append(window_metrics(window, None if targets is None else targets[k]))
        out = {key: torch.stack([m[key] for m in per_window]) for key in per_window[0]}
        out["final_window"] = window
        return out

    return rollout


def rollout_targets(dataset, start_idx: int, num_windows: int):
    """Ground-truth windows aligned with a rollout (host-side numpy).

    Window ``k`` predicts dataset item ``start_idx + k*tw``'s target slice.
    All windows must lie in the trajectory file of ``start_idx``: striding
    across a file boundary would mix trajectories, so it raises."""
    tw = dataset.time_window
    file0, _ = dataset._locate(start_idx)
    targets, timesteps = [], []
    for k in range(num_windows):
        idx = start_idx + k * tw
        file_idx, local_start = dataset._locate(idx)
        if file_idx != file0:
            raise ValueError(
                f"rollout window {k} (dataset index {idx}) crosses a trajectory-"
                f"file boundary (file {file0} -> {file_idx}); shorten num_windows "
                f"or move start_idx"
            )
        targets.append(dataset[idx][1])
        t0 = local_start + tw
        timesteps.append(np.arange(t0, t0 + tw))
    return np.concatenate(targets, axis=0), np.concatenate(timesteps, axis=0)


def denormalize(fields_data: torch.Tensor, fields, diff_terms, div_terms) -> torch.Tensor:
    """Undo the per-field normalization of a ``(..., C, H, W)`` stack."""
    kw = dict(dtype=fields_data.dtype, device=fields_data.device)
    div = torch.tensor([div_terms[f] for f in fields], **kw)
    diff = torch.tensor([diff_terms[f] for f in fields], **kw)
    return fields_data * div[:, None, None] + diff[:, None, None]
