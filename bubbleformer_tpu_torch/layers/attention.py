"""Temporal and axial-spatial attention blocks (channels-last).

Counterpart of ``bubbleformer_tpu/layers/attention.py`` on the routes the
JAX package takes on a TPU (``_resolve_attn_impl``: temporal -> mega or
core, axial -> lane):

* :class:`TemporalAttentionBlock` takes the mega route (``:208-244``), the
  whole branch in :func:`~bubbleformer_tpu_torch.ops.temporal_block_mega.
  mega_temporal_block` with LayerScale gamma folded into the output
  projection, or the core route (``:246,255-277``): InstanceNorm1,
  :func:`~bubbleformer_tpu_torch.ops.temporal_block_mega.
  core_temporal_attention` (K3), InstanceNorm2, the output projection and
  gamma in the activation dtype.  The residual is added outside either.
  ``attn_impl="auto"`` resolves as the JAX package does on a TPU
  (:func:`resolve_temporal_impl`);
* :class:`AxialAttentionBlock` is the lane route (``:446-465``): InstanceNorm1,
  :func:`~bubbleformer_tpu_torch.ops.axial_lane.lane_axial_attention_from_x`,
  InstanceNorm2, the output projection, then ``_epilogue`` (``:596-626``).

Parameters carry the reference torch model's names and shapes: the QKV and
output heads are 1x1-conv weights ``(O, I, 1, 1)``, attn scales
``(1, heads, 1, 1)``, the T5 table ``rel_pos_bias.relative_attention_bias``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bubbleformer_tpu_torch.layers.linear import GeluMLP, dense
from bubbleformer_tpu_torch.layers.norm import InstanceNorm, LayerNorm, accumulation_dtype
from bubbleformer_tpu_torch.layers.positional import RelativePositionBias
from bubbleformer_tpu_torch.layers.stochastic import drop_path
from bubbleformer_tpu_torch.ops.axial_lane import lane_axial_attention_from_x
from bubbleformer_tpu_torch.ops.temporal_block_mega import (
    core_temporal_attention,
    core_temporal_supported,
    mega_temporal_block,
    mega_temporal_supported,
)

TEMPORAL_IMPLS = ("auto", "mega", "core")


def resolve_temporal_impl(impl: str, t: int, h: int, w: int, c: int) -> str:
    """``"mega"`` or ``"core"`` for the temporal branch of a ``(B, T, H, W,
    C)`` input.  ``"auto"`` resolves as the JAX package does on a TPU
    (``layers/attention.py:92-107``): mega where
    :func:`mega_temporal_supported` holds, else core where
    :func:`core_temporal_supported` holds.  Outside both gates the JAX
    package takes its XLA ``unrolled`` route; the port keeps the mega route
    there (the same function in float32)."""
    if impl != "auto":
        return impl
    if mega_temporal_supported(t, h, w, c):
        return "mega"
    return "core" if core_temporal_supported(t, h, w, c) else "mega"


def _head(cin: int, cout: int) -> nn.Conv2d:
    """A 1x1-conv weight container: ``weight (cout, cin, 1, 1)``, ``bias (cout,)``."""
    return nn.Conv2d(cin, cout, 1)


class TemporalAttentionBlock(nn.Module):
    """Self-attention over T at every spatial token; ``(B, T, H, W, C)`` in
    and out."""

    def __init__(self, embed_dim: int = 768, num_heads: int = 12,
                 layer_scale_init_value: float = 1e-6, attn_scale: bool = True,
                 attn_impl: str = "auto", dtype: Optional[torch.dtype] = None):
        super().__init__()
        c, d = embed_dim, embed_dim // num_heads
        if attn_impl not in TEMPORAL_IMPLS:
            raise ValueError(f"attn_impl must be one of {TEMPORAL_IMPLS}, not {attn_impl!r}")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.norm1 = InstanceNorm(c)
        self.norm2 = InstanceNorm(c)
        self.input_head = _head(c, 3 * c)
        self.output_head = _head(c, c)
        self.qnorm = LayerNorm(d)
        self.knorm = LayerNorm(d)
        self.rel_pos_bias = RelativePositionBias(num_heads)
        self.gamma = nn.Parameter(torch.full((c,), layer_scale_init_value))
        self.attn_scale_factor = (
            nn.Parameter(torch.ones(1, num_heads, 1, 1)) if attn_scale else None
        )

    def forward(self, x: torch.Tensor, drop_path_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t, h, w, c = x.shape
        heads = self.num_heads
        scale = None if self.attn_scale_factor is None else self.attn_scale_factor.reshape(heads)
        if resolve_temporal_impl(self.attn_impl, t, h, w, c) == "core":
            # The parameters are the mega route's, so checkpoints interchange.
            xn = self.norm1(x)
            out = core_temporal_attention(
                xn if self.dtype is None else xn.to(self.dtype),
                self.input_head.weight.reshape(3 * c, c), self.input_head.bias,
                self.qnorm.weight, self.qnorm.bias, self.knorm.weight, self.knorm.bias,
                self.rel_pos_bias(t, t), scale, heads=heads,
            )
            out = dense(self.norm2(out), self.output_head.weight.reshape(c, c),
                        self.output_head.bias, self.dtype)
            branch = out * self.gamma.to(out.dtype)
            return drop_path(branch, drop_path_rate, generator, self.training) + x
        # LayerScale folds into the output projection exactly:
        # gamma * (W y + b) == (gamma W) y + gamma b.
        acc = accumulation_dtype(self.gamma.dtype)
        gamma = self.gamma.to(acc)
        wout = self.output_head.weight.reshape(c, c).to(acc) * gamma[:, None]
        bout = self.output_head.bias.to(acc) * gamma
        xin = x if self.dtype is None else x.to(self.dtype)
        branch = mega_temporal_block(
            xin, self.norm1.weight, self.norm1.bias,
            self.input_head.weight.reshape(3 * c, c), self.input_head.bias,
            self.qnorm.weight, self.qnorm.bias, self.knorm.weight, self.knorm.bias,
            self.norm2.weight, self.norm2.bias, wout, bout,
            self.rel_pos_bias(t, t), scale, heads=heads,
        )
        return drop_path(branch, drop_path_rate, generator, self.training) + x


class AxialAttentionBlock(nn.Module):
    """Row + column attention, averaged, then a GeluMLP; ``(B, H, W, C)`` in
    and out (time folded into the batch)."""

    def __init__(self, embed_dim: int = 768, num_heads: int = 12,
                 layer_scale_init_value: float = 1e-6, attn_scale: bool = True,
                 feat_scale: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        c, d = embed_dim, embed_dim // num_heads
        self.num_heads = num_heads
        self.dtype = dtype
        self.norm1 = InstanceNorm(c)
        self.norm2 = InstanceNorm(c)
        self.input_head = _head(c, 3 * c)
        self.output_head = _head(c, c)
        self.qnorm = LayerNorm(d)
        self.knorm = LayerNorm(d)
        self.rel_pos_bias = RelativePositionBias(num_heads)
        self.gamma_att = nn.Parameter(torch.full((c,), layer_scale_init_value))
        self.gamma_mlp = nn.Parameter(torch.full((c,), layer_scale_init_value))
        if attn_scale:
            self.attn_scale_factor_x = nn.Parameter(torch.ones(1, num_heads, 1, 1))
            self.attn_scale_factor_y = nn.Parameter(torch.ones(1, num_heads, 1, 1))
        else:
            self.attn_scale_factor_x = self.attn_scale_factor_y = None
        if feat_scale:
            self.low_freq_scalar = nn.Parameter(torch.zeros(c))
            self.high_freq_scalar = nn.Parameter(torch.zeros(c))
        else:
            self.low_freq_scalar = self.high_freq_scalar = None
        self.mlp = GeluMLP(c, dtype=dtype)
        self.mlp_norm = InstanceNorm(c)

    def forward(self, x: torch.Tensor, drop_path_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        heads = self.num_heads
        inp = x

        def scale(p):
            return None if p is None else p.reshape(heads)

        x = self.norm1(x)
        xin = x if self.dtype is None else x.to(self.dtype)
        x = lane_axial_attention_from_x(
            xin, self.input_head.weight.reshape(3 * c, c), self.input_head.bias,
            self.qnorm.weight, self.qnorm.bias, self.knorm.weight, self.knorm.bias,
            self.rel_pos_bias(w, w), self.rel_pos_bias(h, h),
            scale(self.attn_scale_factor_x), scale(self.attn_scale_factor_y), heads=heads,
        )
        x = self.norm2(x)
        x = dense(x, self.output_head.weight.reshape(c, c), self.output_head.bias, self.dtype)
        return self._epilogue(x, inp, drop_path_rate, generator)

    def _epilogue(self, x, inp, drop_path_rate, generator):
        """feat_scale, LayerScale + DropPath residual, and the MLP sub-block."""
        if self.low_freq_scalar is not None:
            x_low = x.mean(dim=(1, 2), keepdim=True)
            x_high = x - x_low
            x = (x + x_low * self.low_freq_scalar.to(x.dtype)
                 + x_high * self.high_freq_scalar.to(x.dtype))
        x = drop_path(x * self.gamma_att.to(x.dtype), drop_path_rate, generator,
                      self.training) + inp
        y = self.mlp_norm(self.mlp(x))
        return x + drop_path(self.gamma_mlp.to(y.dtype) * y, drop_path_rate, generator,
                             self.training)
