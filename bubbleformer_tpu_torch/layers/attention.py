"""Temporal and axial-spatial attention blocks (channels-last).

Counterpart of ``bubbleformer_tpu/layers/attention.py`` on the routes the
JAX package takes on a TPU.  Both blocks take the models' ``attn_impl``
and resolve ``"auto"`` as ``_resolve_attn_impl`` does there (``:57-128``,
with ``memory_lean=False``: the port has no ``scan_blocks``):

* :class:`TemporalAttentionBlock`: ``mega`` (``:208-244``), the whole branch
  in :func:`~bubbleformer_tpu_torch.ops.temporal_block_mega.
  mega_temporal_block` (K1) with LayerScale gamma folded into the output
  projection; ``core`` (``:246,255-277``): InstanceNorm1,
  :func:`~bubbleformer_tpu_torch.ops.temporal_block_mega.
  core_temporal_attention` (K3), InstanceNorm2, the output projection and
  gamma in the activation dtype; ``flash`` and ``packed`` (``:287-300``):
  InstanceNorm1, the QKV Dense in the activation dtype, qk-LayerNorm cast
  back, the lines ``(heads, B*H*W, T, d)`` through :func:`~bubbleformer_tpu_torch.
  ops.axial_pallas.flash_packed_attention` (K8) or the XLA
  :func:`~bubbleformer_tpu_torch.ops.attention.packed_attention`,
  InstanceNorm2, the output Dense and gamma; ``unrolled`` and ``plain`` (and
  every name that falls through there), the XLA route (``:279-322``): the
  same with :func:`~bubbleformer_tpu_torch.ops.attention.xla_axis_attention`
  on the ``(B, H, W, heads, T, d)`` layout.  The residual is added outside
  any of them.
* :class:`AxialAttentionBlock`: ``mega`` (``:425-444``): the whole branch
  in :func:`~bubbleformer_tpu_torch.ops.axial_block_mega.mega_axial_block`
  (K5), then ``_epilogue`` (``:596-626``); ``lane`` (``:446-465``):
  InstanceNorm1, :func:`~bubbleformer_tpu_torch.ops.axial_lane.
  lane_axial_attention_from_x` (K2; K9, the projection in the kernel, with
  ``BUBBLEFORMER_LANE_PROJ=kernel`` as in the JAX package), InstanceNorm2,
  the output projection, then ``_epilogue``; ``fused_block`` (``:467-489``): the QKV Dense in the
  activation dtype and :func:`~bubbleformer_tpu_torch.ops.axial_fused_block.
  fused_block_attention` (K4) in its place; ``fused_packed`` and ``fused``
  (``:490-502``): the QKV Dense in the activation dtype, qk-LayerNorm cast
  back, then :func:`~bubbleformer_tpu_torch.ops.axial_fused_packed.
  fused_axial_attention_packed` (K6) or :func:`~bubbleformer_tpu_torch.ops.
  axial_fused.fused_axial_attention` (K7); ``flash`` and ``packed``
  (``:506-537``): the QKV Dense, qk-LayerNorm cast back, rows ``(heads,
  B*H, W, d)`` and columns ``(heads, B*W, H, d)`` through K8 or the XLA
  ``packed_attention``, their mean in the activation dtype; ``unrolled``,
  ``plain`` and every name that falls through there, the XLA route
  (``:467-547``).

The XLA routes are not fallbacks: they are what the JAX package computes
there.

Both blocks take ``bias_type`` (``layers/positional.py:make_bias_module``):
``"rel"`` (the T5 table), ``"continuous"`` (the MLP's ``(heads, n, n)``
table, whose gradient the kernels return and autograd carries into the MLP)
or ``"none"`` (every route gets None for its tables and returns no table
gradient).  The axial block evaluates its one bias module at ``(W, W)`` and
``(H, H)``, as the JAX block does (``:411-418``).

Parameters carry the reference torch model's names and shapes on every
route, so checkpoints interchange: the QKV and output heads are 1x1-conv
weights ``(O, I, 1, 1)``, attn scales ``(1, heads, 1, 1)``, the bias module
``rel_pos_bias`` (``relative_attention_bias`` for ``"rel"``, ``cpb_mlp`` for
``"continuous"``, absent for ``"none"``).

Tensor parallelism (``model_shard``, set by ``parallel/sharding.py:
shard_model``): a block holds its rank's ``heads / m`` heads — rows
``(3C / m, C)`` of ``input_head``, columns ``(C, C / m)`` of
``output_head`` — and the whole of every other parameter, slicing its heads'
part of ``norm2``, of the table and of the attn scales.  Routes resolve on
the whole width and head count, as the JAX model sees them.  The temporal
branch runs ``mega`` (K1 on ``copy_to_model(x)``, its output a float32
partial, ``gamma * b_out`` added on model rank 0) or ``core``
(``copy_to_model`` after InstanceNorm1, K3 on the local heads, ``norm2`` on
the local channels, the output projection row-parallel); the axial branch
``lane`` (K2 on the local heads from the local QKV projection, likewise).
Every other route raises ``ValueError`` naming it and ``mesh_cfg``: none
runs unsharded.  The MLP is the sharded ``GeluMLP``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from bubbleformer_tpu_torch.layers.init import dense_
from bubbleformer_tpu_torch.layers.linear import GeluMLP, dense
from bubbleformer_tpu_torch.layers.norm import (
    InstanceNorm,
    LayerNorm,
    accumulation_dtype,
    instance_norm,
)
from bubbleformer_tpu_torch.layers.positional import make_bias_module
from bubbleformer_tpu_torch.layers.stochastic import drop_path
from bubbleformer_tpu_torch.ops.attention import (
    from_cols,
    packed_attention,
    qk_layer_norm,
    to_cols,
    to_rows,
    xla_axis_attention,
)
from bubbleformer_tpu_torch.ops.axial_block_mega import mega_axial_block
from bubbleformer_tpu_torch.ops.axial_fused import fused_axial_attention
from bubbleformer_tpu_torch.ops.axial_fused_block import fused_block_attention
from bubbleformer_tpu_torch.ops.axial_fused_packed import fused_axial_attention_packed
from bubbleformer_tpu_torch.ops.axial_lane import (
    lane_axial_attention_from_x,
    lane_axial_supported,
)
from bubbleformer_tpu_torch.ops.axial_pallas import flash_packed_attention
from bubbleformer_tpu_torch.ops.temporal_block_mega import (
    core_temporal_attention,
    core_temporal_supported,
    mega_temporal_block,
    mega_temporal_supported,
)
from bubbleformer_tpu_torch.parallel.sharding import (
    copy_to_model,
    rank0_bias,
    reduce_from_model,
    row_parallel_dense,
)

# The axial routes of K6 and K7, which take q, k, v after the block's
# qk-LayerNorm.
_SPLIT_KERNELS = {"fused_packed": fused_axial_attention_packed, "fused": fused_axial_attention}
# The routes of both branches over lines (heads, M, n, d) after qk-LayerNorm
# (``bubbleformer_tpu/layers/attention.py:131``).
_PACKED_IMPLS = {"packed": packed_attention, "flash": flash_packed_attention}


def resolve_temporal_impl(impl: str, t: int, h: int, w: int, c: int) -> str:
    """The route of the temporal branch of a ``(B, T, H, W, C)`` input.
    ``"auto"`` resolves as the JAX package does on a TPU
    (``layers/attention.py:92-110``): mega where
    :func:`mega_temporal_supported` holds, else core where
    :func:`core_temporal_supported` holds, else unrolled for T <= 8, flash
    for T >= 64 and plain between.  Any other name is kept."""
    if impl != "auto":
        return impl
    if mega_temporal_supported(t, h, w, c):
        return "mega"
    if core_temporal_supported(t, h, w, c):
        return "core"
    if t <= 8:
        return "unrolled"
    return "flash" if t >= 64 else "plain"


def resolve_axial_impl(impl: str, h: int, w: int, c: int, heads: int) -> str:
    """The route of the axial branch of a ``(BT, H, W, C)`` input.
    ``"auto"`` resolves as the JAX package does on a TPU without
    ``scan_blocks`` (``layers/attention.py:111-127``): lane where
    :func:`lane_axial_supported` holds, else fused_block.  Any other name is
    kept."""
    if impl != "auto":
        return impl
    return "lane" if lane_axial_supported(h, w, c, heads) else "fused_block"


def _table(bias_module: Optional[nn.Module], n: int) -> Optional[torch.Tensor]:
    """The ``(heads, n, n)`` bias table of a block's bias module; None for
    ``bias_type="none"``, which has no module."""
    return None if bias_module is None else bias_module(n, n)


def _unsharded_route(branch: str, impl: str, shard) -> ValueError:
    """The error of a route that tensor parallelism does not shard."""
    return ValueError(
        f"attn_impl={impl!r}: the {branch} branch has no sharded route there; under "
        f"mesh_cfg model={shard.size} (tensor parallelism) it runs "
        f"{'mega (K1) or core (K3)' if branch == 'temporal' else 'lane (K2)'}")


def _local_heads(block, shard):
    """``(heads, head slice, channel slice)`` of the rank's heads."""
    heads = block.num_heads // shard.size
    hs = slice(shard.rank * heads, (shard.rank + 1) * heads)
    return heads, hs, shard.part(block.norm2.weight.shape[0])


def _sliced(a: Optional[torch.Tensor], hs: slice) -> Optional[torch.Tensor]:
    return None if a is None else a[hs]


def _shared_partials(block) -> list:
    """The partial-gradient parameters both blocks' sharded routes have:
    qk-LN (one LayerNorm over ``d`` for all heads), ``norm2`` (sliced per
    rank), the output bias (rank 0's) and the bias module (each rank's
    heads of its table)."""
    if block._route is None:
        raise RuntimeError("partial_gradient_parameters: the sharded block has not run")
    out = [*block.qnorm.parameters(), *block.knorm.parameters(), *block.norm2.parameters(),
           block.output_head.bias]
    if block.rel_pos_bias is not None:
        out += list(block.rel_pos_bias.parameters())
    return out


def _head(cin: int, cout: int) -> nn.Conv2d:
    """A 1x1-conv weight container: ``weight (cout, cin, 1, 1)``, ``bias (cout,)``,
    drawn as flax's ``Dense`` (``input_head``, ``output_head``) draws them."""
    return dense_(nn.Conv2d(cin, cout, 1))


class TemporalAttentionBlock(nn.Module):
    """Self-attention over T at every spatial token; ``(B, T, H, W, C)`` in
    and out."""

    def __init__(self, embed_dim: int = 768, num_heads: int = 12,
                 layer_scale_init_value: float = 1e-6, attn_scale: bool = True,
                 attn_impl: str = "auto", dtype: Optional[torch.dtype] = None,
                 bias_type: str = "rel"):
        super().__init__()
        c, d = embed_dim, embed_dim // num_heads
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.norm1 = InstanceNorm(c)
        self.norm2 = InstanceNorm(c)
        self.input_head = _head(c, 3 * c)
        self.output_head = _head(c, c)
        self.qnorm = LayerNorm(d)
        self.knorm = LayerNorm(d)
        self.rel_pos_bias = make_bias_module(bias_type, num_heads)
        self.gamma = nn.Parameter(torch.full((c,), layer_scale_init_value))
        self.attn_scale_factor = (
            nn.Parameter(torch.ones(1, num_heads, 1, 1)) if attn_scale else None
        )
        self.model_shard = None
        self._route = None  # the route of the last forward (the partial-gradient class)

    def forward(self, x: torch.Tensor, drop_path_rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``: the branch's drop-path keep mask ``(B,)``, in place of one
        drawn from ``generator``."""
        b, t, h, w, c = x.shape
        heads = self.num_heads
        scale = None if self.attn_scale_factor is None else self.attn_scale_factor.reshape(heads)
        bias = _table(self.rel_pos_bias, t)
        impl = resolve_temporal_impl(self.attn_impl, t, h, w, c)
        if self.model_shard is not None:
            branch = self._sharded_branch(x, impl, bias, scale)
            return drop_path(branch, drop_path_rate, generator, self.training, mask) + x
        if impl == "mega":
            return drop_path(self._mega_branch(x, bias, scale), drop_path_rate, generator,
                             self.training, mask) + x
        # The parameters are the mega route's on every route, so checkpoints
        # interchange.
        xn = self.norm1(x)
        if impl == "core":
            out = core_temporal_attention(
                xn if self.dtype is None else xn.to(self.dtype),
                self.input_head.weight.reshape(3 * c, c), self.input_head.bias,
                self.qnorm.weight, self.qnorm.bias, self.knorm.weight, self.knorm.bias,
                bias, scale, heads=heads,
            )
        else:
            qkv = dense(xn, self.input_head.weight.reshape(3 * c, c), self.input_head.bias,
                        self.dtype).reshape(b, t, h, w, heads, 3, c // heads)
            q, k = qk_layer_norm(qkv[..., 0, :], qkv[..., 1, :], self.qnorm, self.knorm)
            v, d = qkv[..., 2, :], c // heads
            if impl in _PACKED_IMPLS:
                def lines(a):  # (b, t, h, w, heads, d) -> (heads, b*h*w, t, d)
                    return a.permute(4, 0, 2, 3, 1, 5).reshape(heads, b * h * w, t, d)

                out = _PACKED_IMPLS[impl](lines(q), lines(k), lines(v), bias, scale)
                out = out.reshape(heads, b, h, w, t, d).permute(1, 4, 2, 3, 0, 5)
            else:
                def seq(a):  # (b, t, h, w, heads, d) -> (b, h, w, heads, t, d)
                    return a.permute(0, 2, 3, 4, 1, 5)

                out = xla_axis_attention(seq(q), seq(k), seq(v), bias, scale,
                                         unrolled=impl == "unrolled")
                out = out.permute(0, 4, 1, 2, 3, 5)
            out = out.reshape(b, t, h, w, c)
        out = dense(self.norm2(out), self.output_head.weight.reshape(c, c),
                    self.output_head.bias, self.dtype)
        branch = out * self.gamma.to(out.dtype)
        return drop_path(branch, drop_path_rate, generator, self.training, mask) + x

    def _sharded_branch(self, x, impl, bias, scale):
        """The branch on the rank's heads (module docstring), the partials
        summed over the model group."""
        shard = self.model_shard
        if impl not in ("mega", "core"):
            raise _unsharded_route("temporal", impl, shard)
        self._route = impl
        c = x.shape[-1]
        heads, hs, cs = _local_heads(self, shard)
        c_a = cs.stop - cs.start
        bias, scale = _sliced(bias, hs), _sliced(scale, hs)
        wqkv = self.input_head.weight.reshape(3 * c_a, c)
        lnp = (self.qnorm.weight, self.qnorm.bias, self.knorm.weight, self.knorm.bias)
        if impl == "mega":
            acc = accumulation_dtype(self.gamma.dtype)
            gamma = self.gamma.to(acc)
            wout = self.output_head.weight.reshape(c, c_a).to(acc) * gamma[:, None]
            xin = copy_to_model(x if self.dtype is None else x.to(self.dtype), shard)
            part = mega_temporal_block(
                xin, self.norm1.weight, self.norm1.bias, wqkv, self.input_head.bias, *lnp,
                self.norm2.weight[cs], self.norm2.bias[cs], wout, None, bias, scale,
                heads=heads, partial=True)
            part = part + rank0_bias(self.output_head.bias.to(acc) * gamma, shard).to(part.dtype)
            return reduce_from_model(part, shard).to(xin.dtype)
        xn = copy_to_model(self.norm1(x), shard)
        ao = core_temporal_attention(xn if self.dtype is None else xn.to(self.dtype), wqkv,
                                     self.input_head.bias, *lnp, bias, scale, heads=heads)
        y = instance_norm(ao, self.norm2.weight[cs], self.norm2.bias[cs], self.norm2.eps)
        out = row_parallel_dense(y, self.output_head.weight.reshape(c, c_a),
                                 self.output_head.bias, self.dtype, shard)
        return out * self.gamma.to(out.dtype)

    def partial_gradient_parameters(self) -> list:
        """Under tensor parallelism, the parameters of the last forward's
        route whose gradient is the rank's share (``parallel/sharding.py``):
        :func:`_shared_partials` and the attn scale; on ``mega`` also
        ``norm1`` (inside K1) and ``gamma`` (folded into the sharded ``wout``
        and the bias)."""
        out = _shared_partials(self)
        if self.attn_scale_factor is not None:
            out.append(self.attn_scale_factor)
        if self._route == "mega":
            out += [*self.norm1.parameters(), self.gamma]
        return out

    def _mega_branch(self, x, bias, scale):
        """K1 with LayerScale folded into the output projection exactly:
        gamma * (W y + b) == (gamma W) y + gamma b."""
        c = x.shape[-1]
        acc = accumulation_dtype(self.gamma.dtype)
        gamma = self.gamma.to(acc)
        wout = self.output_head.weight.reshape(c, c).to(acc) * gamma[:, None]
        bout = self.output_head.bias.to(acc) * gamma
        xin = x if self.dtype is None else x.to(self.dtype)
        return mega_temporal_block(
            xin, self.norm1.weight, self.norm1.bias,
            self.input_head.weight.reshape(3 * c, c), self.input_head.bias,
            self.qnorm.weight, self.qnorm.bias, self.knorm.weight, self.knorm.bias,
            self.norm2.weight, self.norm2.bias, wout, bout,
            bias, scale, heads=self.num_heads,
        )


class AxialAttentionBlock(nn.Module):
    """Row + column attention, averaged, then a GeluMLP; ``(B, H, W, C)`` in
    and out (time folded into the batch)."""

    def __init__(self, embed_dim: int = 768, num_heads: int = 12,
                 layer_scale_init_value: float = 1e-6, attn_scale: bool = True,
                 feat_scale: bool = True, attn_impl: str = "auto",
                 dtype: Optional[torch.dtype] = None, bias_type: str = "rel"):
        super().__init__()
        c, d = embed_dim, embed_dim // num_heads
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.norm1 = InstanceNorm(c)
        self.norm2 = InstanceNorm(c)
        self.input_head = _head(c, 3 * c)
        self.output_head = _head(c, c)
        self.qnorm = LayerNorm(d)
        self.knorm = LayerNorm(d)
        self.rel_pos_bias = make_bias_module(bias_type, num_heads)
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
        self.model_shard = None
        self._route = None  # the route of the last forward (the partial-gradient class)

    def forward(self, x: torch.Tensor, drop_path_rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                masks: Optional[tuple] = None) -> torch.Tensor:
        """``masks``: the drop-path keep masks ``(B,)`` of the attention and
        the MLP residuals, in place of two drawn from ``generator``."""
        b, h, w, c = x.shape
        heads = self.num_heads
        impl = resolve_axial_impl(self.attn_impl, h, w, c, heads)
        inp = x

        def scale(p):
            return None if p is None else p.reshape(heads)

        tables = (_table(self.rel_pos_bias, w), _table(self.rel_pos_bias, h),
                  scale(self.attn_scale_factor_x), scale(self.attn_scale_factor_y))
        lnp = (self.qnorm.weight, self.qnorm.bias, self.knorm.weight, self.knorm.bias)
        if self.model_shard is not None:
            x = self._sharded_attention(x, impl, tables, lnp)
            return self._epilogue(x, inp, drop_path_rate, generator, masks)
        wqkv = self.input_head.weight.reshape(3 * c, c)
        if impl == "mega":
            x = mega_axial_block(
                x if self.dtype is None else x.to(self.dtype), self.norm1.weight,
                self.norm1.bias, wqkv, self.input_head.bias, *lnp, self.norm2.weight,
                self.norm2.bias, self.output_head.weight.reshape(c, c), self.output_head.bias,
                *tables, heads=heads)
            return self._epilogue(x, inp, drop_path_rate, generator, masks)
        x = self.norm1(x)
        if impl == "lane":
            x = lane_axial_attention_from_x(x if self.dtype is None else x.to(self.dtype), wqkv,
                                            self.input_head.bias, *lnp, *tables, heads=heads)
        elif impl == "fused_block":
            qkv = dense(x, wqkv, self.input_head.bias, self.dtype)
            x = fused_block_attention(qkv, *lnp, *tables, heads=heads)
        elif impl in _SPLIT_KERNELS:
            q5 = dense(x, wqkv, self.input_head.bias, self.dtype).reshape(b, h, w, heads, 3,
                                                                          c // heads)
            q, k = qk_layer_norm(q5[..., 0, :], q5[..., 1, :], self.qnorm, self.knorm)
            x = _SPLIT_KERNELS[impl](q, k, q5[..., 2, :], *tables).reshape(b, h, w, c)
        else:
            x = self._xla_attention(dense(x, wqkv, self.input_head.bias, self.dtype), tables,
                                    impl)
        x = self.norm2(x)
        x = dense(x, self.output_head.weight.reshape(c, c), self.output_head.bias, self.dtype)
        return self._epilogue(x, inp, drop_path_rate, generator, masks)

    def _sharded_attention(self, x, impl, tables, lnp):
        """The lane route on the rank's heads (module docstring): its
        output projection's partials summed over the model group."""
        shard = self.model_shard
        if impl != "lane":
            raise _unsharded_route("axial", impl, shard)
        if os.environ.get("BUBBLEFORMER_LANE_PROJ", "xla") == "kernel":
            raise ValueError(
                "BUBBLEFORMER_LANE_PROJ=kernel (K9) has no sharded route; under mesh_cfg "
                f"model={shard.size} (tensor parallelism) the axial branch runs lane (K2)")
        self._route = impl
        c = x.shape[-1]
        heads, hs, cs = _local_heads(self, shard)
        c_a = cs.stop - cs.start
        xn = copy_to_model(self.norm1(x), shard)
        y = lane_axial_attention_from_x(
            xn if self.dtype is None else xn.to(self.dtype),
            self.input_head.weight.reshape(3 * c_a, c), self.input_head.bias, *lnp,
            *(_sliced(a, hs) for a in tables), heads=heads, proj="xla")
        y = instance_norm(y, self.norm2.weight[cs], self.norm2.bias[cs], self.norm2.eps)
        return row_parallel_dense(y, self.output_head.weight.reshape(c, c_a),
                                  self.output_head.bias, self.dtype, shard)

    def partial_gradient_parameters(self) -> list:
        """Under tensor parallelism, the parameters whose gradient is the
        rank's share (``parallel/sharding.py``): :func:`_shared_partials`
        and the attn scales."""
        out = _shared_partials(self)
        out += [p for p in (self.attn_scale_factor_x, self.attn_scale_factor_y) if p is not None]
        return out

    def _xla_attention(self, qkv, tables, impl):
        """The JAX package's routes from the QKV Dense (``layers/
        attention.py:467-547``): qk-LN cast back, rows and columns by K8 or
        the XLA ``packed_attention`` over ``(heads, lines, L, d)``, or by
        :func:`xla_axis_attention` (``plain``, ``unrolled``), their mean in
        the activation dtype."""
        b, h, w, c3 = qkv.shape
        heads = self.num_heads
        c = c3 // 3
        d = c // heads
        q5 = qkv.reshape(b, h, w, heads, 3, d)
        q, k = qk_layer_norm(q5[..., 0, :], q5[..., 1, :], self.qnorm, self.knorm)
        v = q5[..., 2, :]
        bias_x, bias_y, scale_x, scale_y = tables
        if impl in _PACKED_IMPLS:
            fn = _PACKED_IMPLS[impl]

            def rows(a):  # (b, h, w, heads, d) -> (heads, b*h, w, d)
                return a.permute(3, 0, 1, 2, 4).reshape(heads, b * h, w, d)

            def cols(a):  # (b, h, w, heads, d) -> (heads, b*w, h, d)
                return a.permute(3, 0, 2, 1, 4).reshape(heads, b * w, h, d)

            xx = fn(rows(q), rows(k), rows(v), bias_x, scale_x)
            xx = xx.reshape(heads, b, h, w, d).permute(1, 2, 3, 0, 4)
            xy = fn(cols(q), cols(k), cols(v), bias_y, scale_y)
            xy = xy.reshape(heads, b, w, h, d).permute(1, 3, 2, 0, 4)
        else:
            unrolled = impl == "unrolled"
            xx = to_rows(xla_axis_attention(to_rows(q), to_rows(k), to_rows(v), bias_x, scale_x,
                                            unrolled))
            xy = from_cols(xla_axis_attention(to_cols(q), to_cols(k), to_cols(v), bias_y,
                                              scale_y, unrolled))
        return ((xx + xy) * 0.5).reshape(b, h, w, c)

    def _epilogue(self, x, inp, drop_path_rate, generator, masks):
        """feat_scale, LayerScale + DropPath residual, and the MLP sub-block."""
        m_att, m_mlp = (None, None) if masks is None else masks
        if self.low_freq_scalar is not None:
            x_low = x.mean(dim=(1, 2), keepdim=True)
            x_high = x - x_low
            x = (x + x_low * self.low_freq_scalar.to(x.dtype)
                 + x_high * self.high_freq_scalar.to(x.dtype))
        x = drop_path(x * self.gamma_att.to(x.dtype), drop_path_rate, generator,
                      self.training, m_att) + inp
        y = self.mlp_norm(self.mlp(x))
        return x + drop_path(self.gamma_mlp.to(y.dtype) * y, drop_path_rate, generator,
                             self.training, m_mlp)
