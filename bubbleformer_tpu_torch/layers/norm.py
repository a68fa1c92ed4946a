"""Normalization layers (forward only).

Counterpart of ``bubbleformer_tpu/layers/norm.py``.  Both norms compute
their statistics in float32 in a single pass (``E[x^2] - E[x]^2``, clamped at
0) exactly as the JAX package does (``layers/norm.py:38-50``), whatever the
activation dtype, and round the result back to the input dtype.  Parameters
are named ``weight``/``bias`` as in ``torch.nn.InstanceNorm2d`` and
``torch.nn.LayerNorm``, so ``state_dict`` keys are the reference model's.
"""
from __future__ import annotations

import torch
from torch import nn


def instance_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel InstanceNorm of channels-last ``(..., H, W, C)``.

    ``y = x * inv + (bias - mean * inv)`` with ``inv = rsqrt(var + eps) *
    weight`` — the JAX layer's formula, term for term.
    """
    xf = x.float()
    mean = xf.mean(dim=(-3, -2), keepdim=True)
    mean_sq = (xf * xf).mean(dim=(-3, -2), keepdim=True)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps) * weight.float()
    y = xf * inv + (bias.float() - mean * inv)
    return y.to(x.dtype)


def layer_norm_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with float32 single-pass statistics.

    Returns float32, like flax ``nn.LayerNorm`` with float32 parameters;
    callers cast back where the JAX package does."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()


class InstanceNorm(nn.Module):
    """``nn.InstanceNorm2d(C, affine=True)`` semantics on channels-last input."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.weight, self.bias, self.eps)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, float32 statistics, float32 output."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_f32(x, self.weight, self.bias, self.eps)
