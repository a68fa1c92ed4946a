"""Stochastic depth (DropPath).

Counterpart of ``bubbleformer_tpu/layers/stochastic.py``: per-sample
Bernoulli gating of a residual branch, scaled by the keep probability
(timm's ``scale_by_keep``).  The identity in eval mode.  The random bits come
from a ``torch.Generator``, so they differ from JAX's for the same seed:
parity tests run in eval mode.
"""
from __future__ import annotations

from typing import Optional

import torch


def drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
              training: bool) -> torch.Tensor:
    """Drop the whole branch per sample (axis 0) with probability ``rate``."""
    if not training or generator is None:
        return x
    keep = 1.0 - float(rate)
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, generator=generator, device=generator.device) < keep
    scale = 1.0 / max(keep, 1e-8) if keep > 0.0 else 0.0
    return x * (mask.to(device=x.device, dtype=x.dtype) * scale)
