"""Axial vision transformers: AViT and FiLM-conditioned AViT.

Counterpart of ``bubbleformer_tpu/models/axial_vit.py``, unrolled:
``HMLPEmbed -> N SpaceTimeBlocks (drop-path rates linear 0 -> drop_path) ->
HMLPDebed``, with FiLM modulation after the embed for :class:`FiLMAViT`.
The public layout is ``(B, T, C, H, W)``; activations between embed and
debed are channels-last ``(B, T, h, w, E)``, and ``output_layout="nhwc"``
returns the debed pyramid's channels-last ``(B, T, H, W, C)`` (the
channels-last training loss reads it, ``training/module.py``).
``attn_impl`` picks the route of every temporal and every axial branch, as
the JAX models' field of that name does (``layers/attention.py:resolve_temporal_impl``,
``resolve_axial_impl``).
``remat`` (default True) and ``remat_policy`` (``"dots"``, or ``"full"``)
checkpoint each SpaceTimeBlock as the JAX models' fields of those names do
(``layers/remat.py``); remat applies where autograd records, not in a
rollout under ``no_grad``.
``bias_type`` (default ``"rel"``; ``"continuous"`` or ``"none"``) picks
every attention block's position bias, as the JAX models' field of that
name does (``layers/positional.py:make_bias_module``).
Under tensor parallelism (``mesh_cfg=dp_tp``) the training module shards
the model with ``parallel/sharding.py:shard_model``: every block keeps its
rank's heads and every MLP its slices, and heads that do not split over the
model axis raise.
The JAX package's other TPU options (the ``carry="cm"`` layout,
``scan_blocks`` and its ``lean`` boundary, ``spatial_shard_axis``) have no
counterpart here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from bubbleformer_tpu_torch.layers import remat as remat_lib
from bubbleformer_tpu_torch.layers.attention import AxialAttentionBlock, TemporalAttentionBlock
from bubbleformer_tpu_torch.layers.linear import FiLMMLP
from bubbleformer_tpu_torch.layers.patching import HMLPDebed, HMLPEmbed
from bubbleformer_tpu_torch.models._api import register_model

__all__ = ["SpaceTimeBlock", "AViT", "FiLMAViT"]


class SpaceTimeBlock(nn.Module):
    """Temporal attention, then per-frame axial attention; ``(B, T, h, w, C)``."""

    def __init__(self, embed_dim: int = 768, num_heads: int = 12, attn_scale: bool = True,
                 feat_scale: bool = True, layer_scale_init_value: float = 1e-6,
                 attn_impl: str = "auto", dtype: Optional[torch.dtype] = None,
                 bias_type: str = "rel"):
        super().__init__()
        self.temporal = TemporalAttentionBlock(
            embed_dim, num_heads, layer_scale_init_value, attn_scale, attn_impl, dtype=dtype,
            bias_type=bias_type,
        )
        self.spatial = AxialAttentionBlock(
            embed_dim, num_heads, layer_scale_init_value, attn_scale, feat_scale, attn_impl,
            dtype=dtype, bias_type=bias_type,
        )

    def forward(self, x: torch.Tensor, drop_path_rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                masks: Optional[tuple] = None) -> torch.Tensor:
        """``masks``: :meth:`draw_masks`' three keep masks, in place of masks
        drawn from ``generator``."""
        b, t, h, w, c = x.shape
        m_t, *m_s = (None, None, None) if masks is None else masks
        x = self.temporal(x, drop_path_rate, generator, m_t)
        x = self.spatial(x.reshape(b * t, h, w, c), drop_path_rate, generator,
                         None if masks is None else tuple(m_s))
        return x.reshape(b, t, h, w, c)

    def draw_masks(self, shape, drop_path_rate: float, generator: Optional[torch.Generator],
                   shard: Tuple[int, int] = (0, 1)):
        """The drop-path keep masks of a ``(B, T, h, w, C)`` input: the temporal
        residual's ``(B,)``, then the axial attention's and MLP's ``(B*T,)``,
        drawn from ``generator`` as the forward would draw them; None outside
        training or without a generator.  ``shard`` ``(index, count)``: the
        input is the ``index``-th of ``count`` equal shares of a global batch,
        so the masks are drawn for the global batch and this share's rows
        taken."""
        if not self.training or generator is None:
            return None
        keep = 1.0 - float(drop_path_rate)
        b, t = shape[:2]
        index, count = shard
        return tuple((torch.rand((n * count,) + (1,) * nd, generator=generator,
                                 device=generator.device) < keep)[index * n:(index + 1) * n]
                     for n, nd in ((b, 4), (b * t, 3), (b * t, 3)))


@register_model("avit")
class AViT(nn.Module):
    """``(B, T, C_in, H, W) -> (B, T, C_out, H, W)``."""

    def __init__(self, input_fields: int = 3, output_fields: int = 3, time_window: int = 12,
                 patch_size: int = 16, embed_dim: int = 768, num_heads: int = 12,
                 processor_blocks: int = 12, drop_path: float = 0.2, attn_scale: bool = True,
                 feat_scale: bool = True, attn_impl: str = "auto", remat: bool = True,
                 remat_policy: str = "dots", dtype: Optional[torch.dtype] = None,
                 bias_type: str = "rel"):
        super().__init__()
        if patch_size < 2:
            raise ValueError("patch_size must be >= 2")
        self.output_fields = output_fields
        self.embed_dim = embed_dim
        self.remat, self.remat_policy = remat, remat_policy
        self.dtype = dtype
        self.embed = HMLPEmbed(patch_size, input_fields, embed_dim, dtype=dtype)
        self.blocks = nn.ModuleList(
            SpaceTimeBlock(embed_dim, num_heads, attn_scale, feat_scale, attn_impl=attn_impl,
                           dtype=dtype, bias_type=bias_type)
            for _ in range(processor_blocks)
        )
        self.debed = HMLPDebed(patch_size, output_fields, embed_dim, dtype=dtype)
        self.drop_path_rates = [float(r) for r in np.linspace(0.0, drop_path, processor_blocks)]
        # (index, count): the batch is this share of a global one (the
        # training module's data parallelism; the drop-path masks).
        self.batch_shard = (0, 1)

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, C, H, W)`` -> channels-last patch grid ``(B, T, h, w, E)``.

        The NCHW -> NHWC relayout and the first stage's space-to-depth fold
        are one permute, as in the JAX package."""
        b, t, c, hh, ww = x.shape
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.reshape(b * t, c, hh // 2, 2, ww // 2, 2).permute(0, 2, 4, 3, 5, 1)
        x = self.embed(x.reshape(b * t, hh // 2, ww // 2, 4 * c), prefolded=True)
        return x.reshape(b, t, x.shape[1], x.shape[2], self.embed_dim)

    def _process(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The blocks, each checkpointed under ``remat`` where autograd
        records; each block's drop-path masks are drawn before it, so that its
        rerun applies the same ones."""
        for rate, block in zip(self.drop_path_rates, self.blocks):
            masks = block.draw_masks(x.shape, rate, generator, self.batch_shard)
            if self.remat and torch.is_grad_enabled():
                x = remat_lib.checkpoint_block(
                    lambda y, block=block, rate=rate, masks=masks: block(y, rate, masks=masks),
                    x, self.remat_policy)
            else:
                x = block(x, rate, masks=masks)
        return x

    def _decode(self, x: torch.Tensor, output_layout: str = "nchw") -> torch.Tensor:
        """``(B, T, h, w, E)`` -> ``(B, T, C_out, H, W)``, or ``(B, T, H, W,
        C_out)`` for ``output_layout="nhwc"`` (the same parameters: the
        output fold is a pure shuffle)."""
        if output_layout not in ("nchw", "nhwc"):
            raise ValueError(f"output_layout must be nchw|nhwc, got {output_layout!r}")
        b, t = x.shape[:2]
        x = self.debed(x.reshape(b * t, x.shape[2], x.shape[3], self.embed_dim),
                       emit_nchw=output_layout == "nchw")
        return x.reshape(b, t, *x.shape[1:])

    # The forecast module checks this before asking for output_layout.
    supports_output_layout = True

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                output_layout: str = "nchw") -> torch.Tensor:
        """``generator`` draws the drop-path masks in train mode."""
        return self._decode(self._process(self._encode(x), generator), output_layout)


@register_model("filmavit")
class FiLMAViT(AViT):
    """AViT with FiLM conditioning of the post-embed features on the fluid
    parameters ``(B, num_fluid_params)``."""

    def __init__(self, num_fluid_params: int = 9, **kwargs):
        super().__init__(**kwargs)
        self.film_embed = FiLMMLP(num_fluid_params, self.embed_dim, dtype=self.dtype)

    def forward(self, x: torch.Tensor, fluid_params: torch.Tensor,  # type: ignore[override]
                generator: Optional[torch.Generator] = None,
                output_layout: str = "nchw") -> torch.Tensor:
        x = self.film_embed(self._encode(x), fluid_params)
        return self._decode(self._process(x, generator), output_layout)
