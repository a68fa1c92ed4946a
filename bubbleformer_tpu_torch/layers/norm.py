"""Normalization layers.

Counterpart of ``bubbleformer_tpu/layers/norm.py``.  Both norms compute
their statistics in float32 in a single pass (``E[x^2] - E[x]^2``, clamped at
0) exactly as the JAX package does (``layers/norm.py:38-50``), whatever the
activation dtype, and round the result back to the input dtype.  Parameters
are named ``weight``/``bias`` as in ``torch.nn.InstanceNorm2d`` and
``torch.nn.LayerNorm``, so ``state_dict`` keys are the reference model's.

InstanceNorm has the JAX package's hand-written gradient
(``layers/norm.py:32-71``) as a ``torch.autograd.Function``: it keeps the
input in its own dtype and the per-(sample, channel) mean and invstd, and
recomputes ``xhat`` in the backward, instead of the float32 copy of the
input that autograd of the plain expression would keep.
"""
from __future__ import annotations

import torch
from torch import nn

_IN_DIMS = (-3, -2)  # (H, W) of channels-last (..., H, W, C)


def accumulation_dtype(dtype: torch.dtype) -> torch.dtype:
    """float64 for float64 input, else float32: the dtype the norms' statistics
    and the kernels' plain versions compute in (float64 only so that tests
    can hold gradients against float64 autograd)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


class _InstanceNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        acc = accumulation_dtype(x.dtype)
        xf = x.to(acc)
        mean = xf.mean(dim=_IN_DIMS, keepdim=True)
        mean_sq = (xf * xf).mean(dim=_IN_DIMS, keepdim=True)
        invstd = torch.rsqrt(torch.clamp(mean_sq - mean * mean, min=0.0) + eps)
        inv = invstd * weight.to(acc)
        y = xf * inv + (bias.to(acc) - mean * inv)
        ctx.save_for_backward(x, mean, invstd, weight)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, mean, invstd, weight = ctx.saved_tensors
        return (*instance_norm_bwd(x, mean, invstd, weight, dy), None)


def instance_norm_bwd(x, mean, invstd, weight, dy):
    """``(dx, dweight, dbias)`` of :func:`instance_norm` (``_in_bwd`` of the
    JAX package): ``dx = invstd * (g - mean(g) - xhat * mean(g * xhat))``
    with ``g = dy * weight``, in ``x.dtype``; the affine gradients in the
    statistics' dtype."""
    acc = mean.dtype
    dyf = dy.to(acc)
    xhat = (x.to(acc) - mean) * invstd
    batch_dims = tuple(range(x.ndim - 1))
    dweight = (dyf * xhat).sum(dim=batch_dims)
    dbias = dyf.sum(dim=batch_dims)
    g = dyf * weight.to(acc)
    m1 = g.mean(dim=_IN_DIMS, keepdim=True)
    m2 = (g * xhat).mean(dim=_IN_DIMS, keepdim=True)
    dx = (invstd * (g - m1 - xhat * m2)).to(x.dtype)
    return dx, dweight.to(weight.dtype), dbias.to(weight.dtype)


def instance_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel InstanceNorm of channels-last ``(..., H, W, C)``.

    ``y = x * inv + (bias - mean * inv)`` with ``inv = rsqrt(var + eps) *
    weight`` — the JAX layer's formula, term for term — and its hand-written
    gradient.
    """
    return _InstanceNorm.apply(x, weight, bias, eps)


def row_xhat(x: torch.Tensor, eps: float = 1e-5):
    """``(xhat, rstd)`` of ``x`` normalized over its last axis with
    single-pass statistics."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    return (x - mean) * rstd, rstd


def layer_norm_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with float32 single-pass statistics.

    Returns float32 (float64 for float64 input), like flax ``nn.LayerNorm``
    with float32 parameters; callers cast back where the JAX package does."""
    acc = accumulation_dtype(x.dtype)
    xhat, _ = row_xhat(x.to(acc), eps)
    return xhat * weight.to(acc) + bias.to(acc)


def layer_norm_bwd(dy: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
                   weight: torch.Tensor):
    """LayerNorm-over-the-last-axis backward (``_qkln_bwd`` of the TPU
    kernels): ``dx = rstd * (g - mean(g) - xhat * mean(g * xhat))`` with
    ``g = dy * weight``; returns ``(dx, dweight, dbias)`` in ``dy``'s dtype,
    the affine gradients summed over every leading axis."""
    g = dy * weight.to(dy.dtype)
    m1 = g.mean(dim=-1, keepdim=True)
    m2 = (g * xhat).mean(dim=-1, keepdim=True)
    lead = tuple(range(dy.ndim - 1))
    return rstd * (g - m1 - xhat * m2), (dy * xhat).sum(dim=lead), dy.sum(dim=lead)


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
