"""MLP building blocks (channels-last).

Counterpart of ``bubbleformer_tpu/layers/linear.py`` (GeluMLP and FiLMMLP;
SirenMLP is dead code in the reference and is not ported).  ``dense``
follows flax ``nn.Dense(dtype=...)``: input, weight and bias are cast to the
compute dtype and the product comes out in it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bubbleformer_tpu_torch.layers import remat
from bubbleformer_tpu_torch.layers.init import dense_
from bubbleformer_tpu_torch.layers.norm import LayerNorm


class _Linear(torch.autograd.Function):
    """``F.linear`` with autograd's own backward products written out, so
    that under remat ``"dots"`` its output is kept (:func:`remat.reuse`) and
    the block's rerun does not redo the product."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return remat.reuse(lambda: F.linear(x, weight, bias), site=_Linear)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        dy2 = dy.reshape(-1, dy.shape[-1])
        dx = dy2.mm(weight).reshape(x.shape) if need_x else None
        dweight = x.reshape(-1, x.shape[-1]).t().mm(dy2).t() if need_w else None
        return dx, dweight, dy2.sum(0) if ctx.has_bias and need_b else None


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``F.linear(x, weight, bias)``, a 2-D product that remat ``"dots"``
    keeps (:mod:`~bubbleformer_tpu_torch.layers.remat`)."""
    return _Linear.apply(x, weight, bias)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x @ weight.T + bias`` in ``dtype`` (``weight``: torch ``(out, in)``).

    ``dtype=None`` promotes, as flax does: a bfloat16 input against float32
    parameters computes in float32."""
    dt = dtype or torch.promote_types(x.dtype, weight.dtype)
    return linear(x.to(dt), weight.to(dt), None if bias is None else bias.to(dt))


class GeluMLP(nn.Module):
    """``fc1 (C -> 4C) -> exact GELU -> fc2 (4C -> C)`` on the last axis."""

    def __init__(self, hidden_dim: int, exp_factor: float = 4.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        hidden = int(hidden_dim * exp_factor)
        self.fc1 = dense_(nn.Linear(hidden_dim, hidden))
        self.fc2 = dense_(nn.Linear(hidden, hidden_dim))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = dense(x, self.fc1.weight, self.fc1.bias, self.dtype)
        x = F.gelu(x, approximate="none")
        return dense(x, self.fc2.weight, self.fc2.bias, self.dtype)


class FiLMMLP(nn.Module):
    """FiLM: ``LayerNorm(cond) -> Linear -> split (gamma, beta)``, then
    ``gamma * x + beta`` broadcast over ``(B, T, H, W, C)``.

    ``film_net`` is ``Sequential(LayerNorm, Linear)`` so the keys are the
    reference's ``film_net.0.*`` / ``film_net.1.*``."""

    def __init__(self, param_dim: int, embed_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.film_net = nn.Sequential(
            LayerNorm(param_dim), dense_(nn.Linear(param_dim, 2 * embed_dim))
        )
        self.dtype = dtype

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        norm, proj = self.film_net
        gamma_beta = dense(norm(cond), proj.weight, proj.bias, self.dtype)
        gamma, beta = gamma_beta.split(self.embed_dim, dim=-1)  # each (B, C)
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (self.embed_dim,)
        return gamma.reshape(shape).to(x.dtype) * x + beta.reshape(shape).to(x.dtype)
