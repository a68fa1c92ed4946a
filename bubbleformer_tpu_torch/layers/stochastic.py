"""Stochastic depth (DropPath).

Counterpart of ``bubbleformer_tpu/layers/stochastic.py``: per-sample
Bernoulli gating of a residual branch, scaled by the keep probability (timm's
``scale_by_keep``).  The identity in eval mode.  The random bits come from an
explicit ``torch.Generator`` and are drawn on the generator's device, so a
CPU generator gives the same masks to a run on the card and a run on the
CPU.  They differ from JAX's for the same seed: a test that holds the two
packages together draws the keep mask once and hands it to both (``mask``).
"""
from __future__ import annotations

from typing import Optional

import torch


def drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
              training: bool, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drop the whole branch per sample (axis 0) with probability ``rate``.

    ``mask``: a given boolean keep mask ``(B,)`` in place of one drawn from
    ``generator``."""
    if not training or (generator is None and mask is None):
        return x
    keep = 1.0 - float(rate)
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    if mask is None:
        mask = torch.rand(shape, generator=generator, device=generator.device) < keep
    scale = 1.0 / max(keep, 1e-8) if keep > 0.0 else 0.0
    return x * (mask.reshape(shape).to(device=x.device, dtype=x.dtype) * scale)
