"""K7: the axial row + column attention of the ``fused`` route, forward and
backward.

Counterpart of ``bubbleformer_tpu/ops/axial_fused.py:fused_axial_attention``:
K6's boundary (``q``, ``k``, ``v`` ``(BT, H, W, heads, d)`` already
qk-normalised, ``ops/axial_fused_packed.py``) and function, at its own
rounding points.  ``q``, ``k``, ``v``, the probabilities and the blended
``P_eff = s P + (1 - s) / L`` stay float32 (``axial_fused.py:92-100``), and
each direction's ``0.5 * o`` is rounded to the activation dtype before the
two are added in that dtype (``:134``, ``:147``):

    out = dtype(dtype(0.5 P_eff,rows @ v) + dtype(0.5 P_eff,cols @ v))

Its backward (``_bwd_chunk :150``) works in float32 throughout — ``dao = 0.5
dout``, ``dS`` and ``P_eff`` unrounded — and each direction's ``dq``, ``dk``,
``dv`` is rounded before the two are added in the activation dtype
(``:210-233``).  The TPU package reaches the ``(heads, L, L)`` tables through
autodiff of their kron packing outside the kernel (``pack_row_bias :76``,
``pack_col_bias :84``); the port's Function returns the tables' gradients
directly, as sums over every line.

:func:`fused_axial_attention` is a ``torch.autograd.Function``.  On CUDA
tensors its forward and backward launch ``csrc/axial_fused.cu`` (the line
kernels in their kFused flavour: head dims 16 and 64, lines of up to 512
tokens; any other shape raises); on CPU tensors :func:`fused_plain` and
:func:`fused_bwd_plain`; on any other device they raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from bubbleformer_tpu_torch.layers.norm import accumulation_dtype
from bubbleformer_tpu_torch.ops.attention import axis_attention, from_cols, to_cols, to_rows
from bubbleformer_tpu_torch.ops.axial_fused_packed import (
    absent_as_none,
    split_bwd_cuda,
    split_fwd_cuda,
)
from bubbleformer_tpu_torch.ops.axial_lane import LineAttention


def fused_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K7's forward; the arguments of
    :func:`fused_axial_attention`."""
    dt, acc = q.dtype, accumulation_dtype(q.dtype)
    qa, ka, va = q.to(acc), k.to(acc), v.to(acc)
    # fold_dtype=acc: the blended probabilities, unrounded, times v.
    o_r = to_rows(axis_attention(to_rows(qa), to_rows(ka), to_rows(va), bias_x, scale_x,
                                 fold_dtype=acc))
    o_c = from_cols(axis_attention(to_cols(qa), to_cols(ka), to_cols(va), bias_y, scale_y,
                                   fold_dtype=acc))
    return (0.5 * o_r).to(dt) + (0.5 * o_c).to(dt)


def fused_bwd_plain(
    do: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
) -> tuple:
    """Plain PyTorch version of K7's backward: explicit formulas, no autograd.

    Returns the gradients of ``(q, k, v, bias_x, bias_y, scale_x, scale_y)``
    for the output gradient ``do``: ``dq``, ``dk``, ``dv`` in ``q.dtype``, the
    rest float32 (None where the argument is absent).  Per direction, with
    ``dao = 0.5 do`` and ``G = dao v^T``: ``dscale = sum (P - 1/L) G``,
    ``dS = P * (s G - rowsum(s G P))`` (the T5 table's gradient), ``dq = dS k
    / sqrt(d)``, ``dk = dS^T q / sqrt(d)``, ``dv = P_eff^T dao``, all in
    float32; each direction's ``dq``, ``dk``, ``dv`` rounded, then added.
    """
    heads, d, dev = q.shape[-2], q.shape[-1], q.device
    dt, acc = q.dtype, accumulation_dtype(q.dtype)
    qa, ka, va = q.to(acc), k.to(acc), v.to(acc)
    dao = 0.5 * do.to(acc).reshape(q.shape)
    ones = torch.ones(heads, device=dev, dtype=acc)

    def direction(fold, unfold, bias, scale, length):
        qs, ks, vs, ds = fold(qa), fold(ka), fold(va), fold(dao)
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
        p_eff = s * p + (1.0 - s) * (1.0 / length)
        grads = (dlog @ ks * d**-0.5, dlog.transpose(-1, -2) @ qs * d**-0.5,
                 p_eff.transpose(-1, -2) @ ds)
        return [unfold(g).to(dt) for g in grads], dlog.sum(dim=(0, 1)), dscale

    rows, dbx, dsx = direction(to_rows, to_rows, bias_x, scale_x, q.shape[2])
    cols, dby, dsy = direction(to_cols, from_cols, bias_y, scale_y, q.shape[1])
    tables = (bias_x, bias_y, scale_x, scale_y)
    return (*(r + c for r, c in zip(rows, cols)),
            *absent_as_none((dbx, dby, dsx, dsy), tables))


def _fused_fwd(q, k, v, *tables):
    if q.device.type == "cpu":
        return fused_plain(q, k, v, *tables)
    if q.device.type != "cuda":
        raise ValueError(f"fused_axial_attention: unsupported device {q.device}")
    out = split_fwd_cuda(q, k, v, *tables, packed=False, what="fused_axial_attention")
    fused_axial_attention.launches += 1
    return out


def fused_axial_attention_bwd(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *tables) -> tuple:
    """K7's backward: the gradients :func:`fused_bwd_plain` returns.

    CPU tensors take :func:`fused_bwd_plain`; CUDA tensors launch
    ``csrc/axial_fused.cu``'s backward in the kFused flavour (the row pass
    writes its rounded gradients, the column pass adds its own) and count
    ``fused_axial_attention_bwd.launches``.  The table and scale gradients
    come from per-block partials added in a fixed order: they repeat bit for
    bit."""
    if q.device.type == "cpu":
        return fused_bwd_plain(do, q, k, v, *tables)
    if q.device.type != "cuda":
        raise ValueError(f"fused_axial_attention_bwd: unsupported device {q.device}")
    grads = split_bwd_cuda(do, q, k, v, *tables, packed=False, what="fused_axial_attention_bwd")
    fused_axial_attention_bwd.launches += 1
    return grads


def fused_axial_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Averaged row/column attention ``(BT, H, W, heads, d)`` from qk-normed
    ``q``, ``k`` and ``v`` of that shape (float32 or bfloat16, one dtype),
    differentiable in every argument; the arguments of
    :func:`~bubbleformer_tpu_torch.ops.axial_fused_packed.
    fused_axial_attention_packed`.  CPU tensors take the plain versions; CUDA
    tensors launch the kernels (``fused_axial_attention.launches`` and
    ``fused_axial_attention_bwd.launches`` count them)."""
    return LineAttention.apply(_fused_fwd, fused_axial_attention_bwd, {}, q, k, v, bias_x,
                               bias_y, scale_x, scale_y)


fused_axial_attention.launches = 0
fused_axial_attention_bwd.launches = 0
