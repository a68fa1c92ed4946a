"""K4: the axial row + column attention of the ``fused_block`` route, forward
and backward.

Counterpart of ``bubbleformer_tpu/ops/axial_fused_block.py:
fused_block_attention``: from the raw interleaved QKV tensor ``(BT, H, W,
3C)`` that the block's dtype Dense writes (per head ``[q|k|v]``), per-head
qk-LayerNorm, attention along each row (over W, ``bias_x``, ``scale_x``) and
each column (over H, ``bias_y``, ``scale_y``), and the mean of the two.  It
is K2's function at other rounding points (``axial_fused_block.py:103-135``):
per direction

    o = s * (dtype(P) @ v) + (1 - s) * mean(v)

with ``pv``, the window mean of ``v`` and ``o`` in float32, and the output
``dtype(0.5 * o_rows + 0.5 * o_cols)`` summed in float32.  Its backward
(``_bwd_chunk``, ``axial_fused_packed.py:192``, and the in-kernel LayerNorm
backward, ``axial_fused_block.py:217-250``) keeps each direction's ``dq``,
``dk`` and ``dv`` in float32, sums the two directions, runs the qk-LN
backward on the sum and rounds ``dqkv`` once.

:func:`fused_block_attention` is a ``torch.autograd.Function``.  On CUDA
tensors its forward and backward launch ``csrc/axial_attention.cu`` in its
fused_block flavour (head dims 16 and 64, lines of up to 512 tokens; any
other shape raises); on CPU tensors :func:`fused_block_plain` and
:func:`fused_block_bwd_plain`; on any other device they raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from bubbleformer_tpu_torch.layers.norm import (
    accumulation_dtype,
    layer_norm_bwd,
    layer_norm_f32,
    row_xhat,
)
from bubbleformer_tpu_torch.ops.attention import from_cols, to_cols, to_rows
from bubbleformer_tpu_torch.ops.axial_lane import (
    LineAttention,
    line_attention_bwd_cuda,
    line_attention_fwd_cuda,
)


def _direction_fwd(q, k, v, bias, scale, dt):
    """One direction on ``(batch..., heads, L, d)`` float32 (float64) q, k, v:
    ``s * (dtype(P) @ v) + (1 - s) * mean(v)``."""
    heads, seq, d = q.shape[-3], q.shape[-2], q.shape[-1]
    logits = q @ k.transpose(-1, -2) * d**-0.5
    if bias is not None:
        logits = logits + bias.to(q.dtype)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    pv = p.to(dt).to(q.dtype) @ v
    s = (torch.ones(heads, device=q.device, dtype=q.dtype) if scale is None
         else scale.to(q.dtype)).reshape(heads, 1, 1)
    return s * pv + (1.0 - s) * v.mean(dim=-2, keepdim=True)


def fused_block_plain(
    qkv: torch.Tensor, qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of K4's forward; the arguments of
    :func:`fused_block_attention`."""
    bt, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    dt, acc = qkv.dtype, accumulation_dtype(qkv.dtype)
    q5 = qkv.reshape(bt, h, w, heads, 3, d)
    q = layer_norm_f32(q5[..., 0, :], qn_scale, qn_bias).to(dt).to(acc)
    k = layer_norm_f32(q5[..., 1, :], kn_scale, kn_bias).to(dt).to(acc)
    v = q5[..., 2, :].to(acc)
    o_r = to_rows(_direction_fwd(to_rows(q), to_rows(k), to_rows(v), bias_x, scale_x, dt))
    o_c = from_cols(_direction_fwd(to_cols(q), to_cols(k), to_cols(v), bias_y, scale_y, dt))
    return (0.5 * o_r + 0.5 * o_c).reshape(bt, h, w, c).to(dt)


def fused_block_bwd_plain(
    do: torch.Tensor, qkv: torch.Tensor, qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int,
) -> tuple:
    """Plain PyTorch version of K4's backward: explicit formulas, no autograd.

    Returns the gradients of ``(qkv, qn_scale, qn_bias, kn_scale, kn_bias,
    bias_x, bias_y, scale_x, scale_y)`` for the output gradient ``do``:
    ``dqkv`` in ``qkv.dtype``, the rest float32 (None where the argument is
    absent).  Per direction, with ``dao = dtype(0.5 do)`` and ``G = dao
    v^T``: ``dscale = sum (P - 1/L) G``, ``dS = P * (s G - rowsum(s G P))``
    (the T5 table's gradient), ``dq = dtype(dS) k / sqrt(d)``, ``dk =
    dtype(dS)^T q / sqrt(d)``, ``dv = dtype(P)^T dtype(s dao) + (1 - s)
    sum_i dao_i / L``; the two directions' ``dq``, ``dk``, ``dv`` summed in
    float32, then the qk-LN backward and one rounding.
    """
    bt, h, w, c3 = qkv.shape
    c = c3 // 3
    d, dt, dev = c // heads, qkv.dtype, qkv.device
    acc = accumulation_dtype(dt)
    q5 = qkv.to(acc).reshape(bt, h, w, heads, 3, d)
    qhat, qrstd = row_xhat(q5[..., 0, :])
    khat, krstd = row_xhat(q5[..., 1, :])
    q = (qhat * qn_scale.to(acc) + qn_bias.to(acc)).to(dt).to(acc)
    k = (khat * kn_scale.to(acc) + kn_bias.to(acc)).to(dt).to(acc)
    v = q5[..., 2, :]
    dao = (0.5 * do.to(acc)).to(dt).to(acc).reshape(bt, h, w, heads, d)
    ones = torch.ones(heads, device=dev, dtype=acc)

    def direction(fold, unfold, bias, scale, length):
        qs, ks, vs, ds = fold(q), fold(k), fold(v), fold(dao)
        logits = qs @ ks.transpose(-1, -2) * d**-0.5
        if bias is not None:
            logits = logits + bias.to(acc)
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        s = (ones if scale is None else scale.to(acc)).reshape(heads, 1, 1)
        g = ds @ vs.transpose(-1, -2)
        dscale = ((p - 1.0 / length) * g).sum(dim=(0, 1, 3, 4))
        dp = s * g
        dlog = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dlog_r = dlog.to(dt).to(acc)
        dq = unfold((dlog_r @ ks) * d**-0.5)
        dk = unfold((dlog_r.transpose(-1, -2) @ qs) * d**-0.5)
        dv = (p.to(dt).to(acc).transpose(-1, -2) @ (s * ds).to(dt).to(acc)
              + ((1.0 - s) * ds).sum(dim=-2, keepdim=True) / length)
        return dq, dk, unfold(dv), dlog.sum(dim=(0, 1)), dscale

    dq_r, dk_r, dv_r, dbx, dsx = direction(to_rows, to_rows, bias_x, scale_x, w)
    dq_c, dk_c, dv_c, dby, dsy = direction(to_cols, from_cols, bias_y, scale_y, h)
    dqr, dgq, dbq = layer_norm_bwd(dq_r + dq_c, qhat, qrstd, qn_scale)
    dkr, dgk, dbk = layer_norm_bwd(dk_r + dk_c, khat, krstd, kn_scale)
    dqkv = torch.stack([dqr, dkr, dv_r + dv_c], dim=-2).to(dt).reshape(bt, h, w, c3)
    return (dqkv, dgq, dbq, dgk, dbk,
            None if bias_x is None else dbx, None if bias_y is None else dby,
            None if scale_x is None else dsx, None if scale_y is None else dsy)


def _fused_block_fwd(qkv, *params, heads):
    if qkv.device.type == "cpu":
        return fused_block_plain(qkv, *params, heads=heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_block_attention: unsupported device {qkv.device}")
    out = line_attention_fwd_cuda(qkv, *params, heads=heads, fused=True,
                                  what="fused_block_attention")
    fused_block_attention.launches += 1
    return out


def fused_block_attention_bwd(do: torch.Tensor, qkv: torch.Tensor, *params,
                              heads: int) -> tuple:
    """K4's backward: the gradients :func:`fused_block_bwd_plain` returns.

    CPU tensors take :func:`fused_block_bwd_plain`; CUDA tensors launch
    ``csrc/axial_attention.cu``'s backward in the fused_block flavour (the
    row pass keeps float32 gradients, the column pass adds its own, runs the
    qk-LN backward and rounds) and count
    ``fused_block_attention_bwd.launches``.  The parameter gradients are
    float32 atomic sums: their last bits vary from run to run."""
    if qkv.device.type == "cpu":
        return fused_block_bwd_plain(do, qkv, *params, heads=heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_block_attention_bwd: unsupported device {qkv.device}")
    grads = line_attention_bwd_cuda(do, qkv, *params, heads=heads, fused=True,
                                    what="fused_block_attention_bwd")
    fused_block_attention_bwd.launches += 1
    return grads


def fused_block_attention(
    qkv: torch.Tensor, qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int,
) -> torch.Tensor:
    """Averaged row/column attention ``(BT, H, W, C)`` from the raw
    interleaved QKV tensor ``qkv`` ``(BT, H, W, 3C)`` (float32 or bfloat16),
    differentiable in every argument; the arguments of
    :func:`~bubbleformer_tpu_torch.ops.axial_lane.lane_axial_attention`.
    CPU tensors take the plain versions; CUDA tensors launch the kernels
    (``fused_block_attention.launches`` and
    ``fused_block_attention_bwd.launches`` count them)."""
    return LineAttention.apply(_fused_block_fwd, fused_block_attention_bwd, heads, qkv,
                               qn_scale, qn_bias, kn_scale, kn_bias, bias_x, bias_y, scale_x,
                               scale_y)


fused_block_attention.launches = 0
fused_block_attention_bwd.launches = 0
