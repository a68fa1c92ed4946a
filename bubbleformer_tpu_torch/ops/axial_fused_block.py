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
``dtype(0.5 * o_rows + 0.5 * o_cols)`` summed in float32: K6's attention
(``ops/axial_fused_packed.py``) after an in-kernel qk-LayerNorm.  Its
backward (``_bwd_chunk``, ``axial_fused_packed.py:192``, and the in-kernel
LayerNorm backward, ``axial_fused_block.py:217-250``) keeps each direction's
``dq``, ``dk`` and ``dv`` in float32, sums the two directions, runs the
qk-LN backward on the sum and rounds ``dqkv`` once.

:func:`fused_block_attention` is a ``torch.autograd.Function``.  On CUDA
tensors its forward and backward launch hand-written kernels, chosen by
dtype in one place (:func:`fused_block_kernels`): bfloat16 runs K2's Hopper
kernels (``csrc/lane_hopper.cuh``) in this rounding, ``Mode::kFusedBlock``
(C entries ``csrc/axial_lane_hopper.cu``: q, k and v staged in bf16, every
product on the tensor cores, the row pass's half of the output and its
``d(q, k, v)`` in float32 scratches; :func:`fused_block_hopper_fwd`,
:func:`fused_block_hopper_bwd`); float32 runs the line kernels of
``csrc/axial_attention.cu`` in their fused_block flavour
(:func:`fused_block_line_fwd`, :func:`fused_block_line_bwd`).  Both take
head dims 16 and 64 and lines of up to 512 tokens (any other shape raises),
and sum the table, scale and LN gradients in a fixed order: they repeat bit
for bit.  On CPU tensors :func:`fused_block_plain` and
:func:`fused_block_bwd_plain`; on any other device they raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.layers.norm import (
    accumulation_dtype,
    layer_norm_bwd,
    layer_norm_f32,
    row_xhat,
)
from bubbleformer_tpu_torch.ops.axial_fused_packed import (
    absent_as_none,
    packed_attention_bwd,
    packed_attention_f32,
)
from bubbleformer_tpu_torch.ops.axial_lane import (
    MODE_FUSED_BLOCK,
    LineAttention,
    kernel_params,
    lane_bwd_scratch,
    line_attention_bwd_cuda,
    line_attention_fwd_cuda,
)


def fused_block_f32(qkv, qn_scale, qn_bias, kn_scale, kn_bias, bias_x=None, bias_y=None,
                    scale_x=None, scale_y=None, *, heads: int) -> torch.Tensor:
    """K4's forward before its one rounding: ``0.5 * o_rows + 0.5 * o_cols``
    ``(BT, H, W, C)`` in the accumulation dtype (K5 keeps it so, as ``ao``)."""
    bt, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    dt, acc = qkv.dtype, accumulation_dtype(qkv.dtype)
    q5 = qkv.reshape(bt, h, w, heads, 3, d)
    q = layer_norm_f32(q5[..., 0, :], qn_scale, qn_bias).to(dt).to(acc)
    k = layer_norm_f32(q5[..., 1, :], kn_scale, kn_bias).to(dt).to(acc)
    v = q5[..., 2, :].to(acc)
    out = packed_attention_f32(q, k, v, bias_x, bias_y, scale_x, scale_y, dt)
    return out.reshape(bt, h, w, c)


def fused_block_plain(
    qkv: torch.Tensor, qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of K4's forward; the arguments of
    :func:`fused_block_attention`."""
    return fused_block_f32(qkv, qn_scale, qn_bias, kn_scale, kn_bias, bias_x, bias_y, scale_x,
                           scale_y, heads=heads).to(qkv.dtype)


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
    absent).  The attention's backward is K6's
    (:func:`~bubbleformer_tpu_torch.ops.axial_fused_packed.packed_attention_bwd`):
    the two directions' ``dq``, ``dk``, ``dv`` summed in float32, then the
    qk-LN backward and one rounding.
    """
    bt, h, w, c3 = qkv.shape
    c = c3 // 3
    d, dt = c // heads, qkv.dtype
    acc = accumulation_dtype(dt)
    q5 = qkv.to(acc).reshape(bt, h, w, heads, 3, d)
    qhat, qrstd = row_xhat(q5[..., 0, :])
    khat, krstd = row_xhat(q5[..., 1, :])
    q = (qhat * qn_scale.to(acc) + qn_bias.to(acc)).to(dt).to(acc)
    k = (khat * kn_scale.to(acc) + kn_bias.to(acc)).to(dt).to(acc)
    tables = (bias_x, bias_y, scale_x, scale_y)
    dq, dk, dv, *grads = packed_attention_bwd(do, q, k, q5[..., 2, :], *tables, dt)
    dqr, dgq, dbq = layer_norm_bwd(dq, qhat, qrstd, qn_scale)
    dkr, dgk, dbk = layer_norm_bwd(dk, khat, krstd, kn_scale)
    dqkv = torch.stack([dqr, dkr, dv], dim=-2).to(dt).reshape(bt, h, w, c3)
    return (dqkv, dgq, dbq, dgk, dbk, *absent_as_none(grads, tables))


def fused_block_hopper_fwd(qkv: torch.Tensor, *params, heads: int) -> torch.Tensor:
    """K4's bf16 forward on the Hopper kernels (``csrc/lane_hopper.cuh``,
    ``Mode::kFusedBlock``; C entry ``bf_fused_block_hopper_fwd``): rows, then
    columns, the row pass's half of the output in a float32 scratch and the
    sum rounded once.  Counts ``fused_block_hopper_fwd.launches``."""
    bt, h, w, c3 = qkv.shape
    c = c3 // 3
    what = "fused_block_attention (bf_fused_block_hopper_fwd)"
    p = kernel_params(qkv, *params, heads, what)
    qkv = qkv.contiguous()
    half = torch.empty(bt, h, w, c, device=qkv.device)
    out = torch.empty(bt, h, w, c, device=qkv.device, dtype=qkv.dtype)
    _build.check_tma(what, qkv=qkv, out=out)
    lib = _build.library()
    err = lib.bf_fused_block_hopper_fwd(
        c // heads, qkv.data_ptr(), p["ln"].data_ptr(), p["bias_x"].data_ptr(),
        p["bias_y"].data_ptr(), p["scale"].data_ptr(), half.data_ptr(), out.data_ptr(), bt, h, w,
        c, heads, _build.stream_handle(qkv.device))
    _build.check(lib, err, what)
    fused_block_hopper_fwd.launches += 1
    return out


def fused_block_hopper_bwd(do: torch.Tensor, qkv: torch.Tensor, *params, heads: int) -> tuple:
    """K4's bf16 backward on the Hopper kernels (C entry
    ``bf_fused_block_hopper_bwd``): one launch a direction, the row pass's
    ``d(q, k, v)`` in a float32 scratch, the column pass adding its own,
    running the qk-LN backward on the sum and rounding once; then one launch
    that adds the blocks' partials in a fixed order.  The gradients
    :func:`fused_block_bwd_plain` returns; counts
    ``fused_block_hopper_bwd.launches``."""
    bt, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    what = "fused_block_attention_bwd (bf_fused_block_hopper_bwd)"
    p = kernel_params(qkv, *params, heads, what)
    _build.check_shapes(what, do=(do, (bt, h, w, c)))
    dev = qkv.device
    qkv, do = qkv.contiguous(), do.to(qkv.dtype).contiguous()
    dqkv = torch.empty_like(qkv)
    dacc = torch.empty(qkv.shape, device=dev)
    _build.check_tma(what, qkv=qkv, do=do, dqkv=dqkv)
    part, plan = lane_bwd_scratch(bt, h, w, heads, d, dev, MODE_FUSED_BLOCK)
    f32 = dict(device=dev, dtype=torch.float32)
    dln = torch.empty(4, d, **f32)
    dbx, dby = torch.empty(heads, w, w, **f32), torch.empty(heads, h, h, **f32)
    dscale = torch.empty(heads, 2, **f32)
    lib = _build.library()
    err = lib.bf_fused_block_hopper_bwd(
        d, qkv.data_ptr(), do.data_ptr(), p["ln"].data_ptr(), p["bias_x"].data_ptr(),
        p["bias_y"].data_ptr(), p["scale"].data_ptr(), dqkv.data_ptr(), dacc.data_ptr(),
        part.data_ptr(), dln.data_ptr(), dbx.data_ptr(), dby.data_ptr(), dscale.data_ptr(), bt,
        h, w, c, heads, *plan, _build.stream_handle(dev))
    _build.check(lib, err, what)
    fused_block_hopper_bwd.launches += 1
    bias_x, bias_y, scale_x, scale_y = params[4:]
    return (dqkv, dln[0], dln[1], dln[2], dln[3],
            None if bias_x is None else dbx, None if bias_y is None else dby,
            None if scale_x is None else dscale[:, 0], None if scale_y is None else dscale[:, 1])


def _float32_only(qkv: torch.Tensor, what: str) -> None:
    """The line kernels' fused_block flavour is built in float32 alone:
    bfloat16 K4 runs the Hopper kernels (:func:`fused_block_kernels`)."""
    if qkv.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 (bfloat16 runs fused_block_hopper_fwd and "
                        f"fused_block_hopper_bwd), not {qkv.dtype}")


def fused_block_line_fwd(qkv: torch.Tensor, *params, heads: int) -> torch.Tensor:
    """K4's float32 forward on the line kernels (``csrc/axial_attention.cu``,
    fused_block flavour); counts ``fused_block_line_fwd.launches``."""
    _float32_only(qkv, "fused_block_line_fwd")
    out = line_attention_fwd_cuda(qkv, *params, heads=heads, fused=True,
                                  what="fused_block_attention")
    fused_block_line_fwd.launches += 1
    return out


def fused_block_line_bwd(do: torch.Tensor, qkv: torch.Tensor, *params, heads: int) -> tuple:
    """K4's float32 backward on the line kernels (the row pass keeps float32
    gradients, the column pass adds its own, runs the qk-LN backward and
    rounds; the parameter gradients from the clusters' partials added in a
    fixed order); counts ``fused_block_line_bwd.launches``."""
    _float32_only(qkv, "fused_block_line_bwd")
    grads = line_attention_bwd_cuda(do, qkv, *params, heads=heads, fused=True,
                                    what="fused_block_attention_bwd")
    fused_block_line_bwd.launches += 1
    return grads


fused_block_hopper_fwd.launches = fused_block_hopper_bwd.launches = 0
fused_block_line_fwd.launches = fused_block_line_bwd.launches = 0


def fused_block_kernels(dtype: torch.dtype) -> tuple:
    """K4's ``(forward, backward)`` kernels on the card for ``dtype``: the
    Hopper kernels for bfloat16, the line kernels for float32; any other
    dtype raises."""
    if dtype == torch.bfloat16:
        return fused_block_hopper_fwd, fused_block_hopper_bwd
    if dtype == torch.float32:
        return fused_block_line_fwd, fused_block_line_bwd
    raise TypeError(f"fused_block_attention kernel takes float32 or bfloat16, not {dtype}")


def _fused_block_fwd(qkv, *params, heads):
    if qkv.device.type == "cpu":
        return fused_block_plain(qkv, *params, heads=heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_block_attention: unsupported device {qkv.device}")
    out = fused_block_kernels(qkv.dtype)[0](qkv, *params, heads=heads)
    fused_block_attention.launches += 1
    return out


def fused_block_attention_bwd(do: torch.Tensor, qkv: torch.Tensor, *params,
                              heads: int) -> tuple:
    """K4's backward: the gradients :func:`fused_block_bwd_plain` returns.

    CPU tensors take :func:`fused_block_bwd_plain`; CUDA tensors the kernels
    :func:`fused_block_kernels` picks by dtype (bfloat16
    :func:`fused_block_hopper_bwd`, float32 :func:`fused_block_line_bwd`)
    and count ``fused_block_attention_bwd.launches``.  The parameter
    gradients come from partials added in a fixed order: they repeat bit for
    bit."""
    if qkv.device.type == "cpu":
        return fused_block_bwd_plain(do, qkv, *params, heads=heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_block_attention_bwd: unsupported device {qkv.device}")
    grads = fused_block_kernels(qkv.dtype)[1](do, qkv, *params, heads=heads)
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
    return LineAttention.apply(_fused_block_fwd, fused_block_attention_bwd, {"heads": heads},
                               qkv, qn_scale, qn_bias, kn_scale, kn_bias, bias_x, bias_y, scale_x,
                               scale_y)


fused_block_attention.launches = 0
fused_block_attention_bwd.launches = 0
