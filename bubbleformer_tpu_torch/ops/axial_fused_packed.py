"""K6: the axial row + column attention of the ``fused_packed`` route, forward
and backward.

Counterpart of ``bubbleformer_tpu/ops/axial_fused_packed.py:
fused_axial_attention_packed``: from ``q``, ``k``, ``v`` ``(BT, H, W, heads,
d)`` already qk-normalised by the block, attention along each row (over W,
``bias_x``, ``scale_x``) and each column (over H, ``bias_y``, ``scale_y``),
and the mean of the two.  Per direction (``_fwd_kernel :133``)

    o = s * (dtype(P) @ v) + (1 - s) * mean(v)

with ``pv``, the window mean and ``o`` in float32, and the output
``dtype(0.5 * o_rows + 0.5 * o_cols)`` summed in float32 (``o_s`` is a
float32 scratch, ``:371``).  Its backward (``_bwd_chunk :192``) rounds
``dao = dtype(0.5 dout)``, ``s * dao``, ``P`` and ``dS`` before their
products, keeps each direction's ``dq``, ``dk`` and ``dv`` in float32, sums
the two directions and rounds once.  The TPU kernel's head packing, -1e9
block-diagonal tables and ``R @ bias_y @ R^T`` spreads mask the packed
products to exactly this per-line attention; the table gradients come out
as ``(heads, L, L)`` sums.

This is K4's attention without its in-kernel LayerNorm: K4
(``ops/axial_fused_block.py``) and K5 (``ops/axial_block_mega.py``) share
:func:`packed_attention_f32` and :func:`packed_attention_bwd`, as their TPU
kernels import this module's helpers.

:func:`fused_axial_attention_packed` is a ``torch.autograd.Function``.  On
CUDA tensors its forward and backward launch hand-written kernels, chosen by
dtype in one place (:func:`fused_packed_kernels`): bfloat16 runs K4's Hopper
kernels without the qk-LN (``csrc/lane_hopper.cuh``, ``Mode::kFusedPacked``;
C entries ``csrc/axial_lane_hopper.cu``: q, k and v read in place with their
own strides, as the block's views hand them over, every product on the
tensor cores, the row pass's half of the output and its ``d(q, k, v)`` in
float32 scratches; :func:`fused_packed_hopper_fwd`,
:func:`fused_packed_hopper_bwd`); float32 runs the line kernels of
``csrc/axial_fused.cu`` in their kPacked flavour
(:func:`fused_packed_line_fwd`, :func:`fused_packed_line_bwd`; K7 takes
them in its kFused flavour, ``ops/axial_fused.py``).  Both take head dims
16 and 64 and lines of up to 512 tokens (any other shape raises) and sum
the table and scale gradients in a fixed order: they repeat bit for bit.
On CPU tensors :func:`fused_packed_plain` and :func:`fused_packed_bwd_plain`;
on any other device they raise.

The line kernels read one ``(3, BT, H, W, C)`` tensor of q, k and v, so
their wrappers (:func:`split_fwd_cuda`, :func:`split_bwd_cuda`) stack the
three into one copy, and copy ``do``, before each launch: the float32
paths pay that copy (94 MB written and read at the training shape), and so
does K7's bfloat16 backward on lines its Hopper backward does not stage.
The bfloat16 Hopper paths read the views in place (a view the kernels
cannot read, :func:`~bubbleformer_tpu_torch._build.in_place_strides`,
raises, naming it) and copy nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.layers.norm import accumulation_dtype
from bubbleformer_tpu_torch.ops.attention import from_cols, to_cols, to_rows
from bubbleformer_tpu_torch.ops.axial_lane import (
    LINE_TILE,
    MODE_FUSED_PACKED,
    LineAttention,
    check_line_shape,
    lane_bwd_scratch,
    line_bwd_scratch,
    line_tables,
)


def _direction_fwd(q, k, v, bias, scale, dt):
    """One direction on ``(batch..., heads, L, d)`` float32 (float64) q, k, v:
    ``s * (dtype(P) @ v) + (1 - s) * mean(v)``."""
    heads, d = q.shape[-3], q.shape[-1]
    logits = q @ k.transpose(-1, -2) * d**-0.5
    if bias is not None:
        logits = logits + bias.to(q.dtype)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    pv = p.to(dt).to(q.dtype) @ v
    s = (torch.ones(heads, device=q.device, dtype=q.dtype) if scale is None
         else scale.to(q.dtype)).reshape(heads, 1, 1)
    return s * pv + (1.0 - s) * v.mean(dim=-2, keepdim=True)


def packed_attention_f32(q, k, v, bias_x, bias_y, scale_x, scale_y, dt):
    """``0.5 * o_rows + 0.5 * o_cols`` in the accumulation dtype, unrounded:
    the attention of K4, K5 and K6 on ``(BT, H, W, heads, d)`` q, k, v in the
    accumulation dtype holding ``dt`` values."""
    o_r = to_rows(_direction_fwd(to_rows(q), to_rows(k), to_rows(v), bias_x, scale_x, dt))
    o_c = from_cols(_direction_fwd(to_cols(q), to_cols(k), to_cols(v), bias_y, scale_y, dt))
    return 0.5 * o_r + 0.5 * o_c


def packed_attention_bwd(do, q, k, v, bias_x, bias_y, scale_x, scale_y, dt):
    """The backward of :func:`packed_attention_f32` for the output gradient
    ``do`` (any dtype): ``(dq, dk, dv, dbias_x, dbias_y, dscale_x,
    dscale_y)``, the first three summed over both directions in the
    accumulation dtype and unrounded.

    Per direction, with ``dao = dtype(0.5 do)`` and ``G = dao v^T``:
    ``dscale = sum (P - 1/L) G``, ``dS = P * (s G - rowsum(s G P))`` (the T5
    table's gradient), ``dq = dtype(dS) k / sqrt(d)``, ``dk = dtype(dS)^T q /
    sqrt(d)``, ``dv = dtype(P)^T dtype(s dao) + (1 - s) sum_i dao_i / L``
    (``axial_fused_packed.py:_bwd_chunk``)."""
    heads, d, dev = q.shape[-2], q.shape[-1], q.device
    acc = q.dtype
    dao = (0.5 * do.to(acc)).to(dt).to(acc).reshape(q.shape)
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

    dq_r, dk_r, dv_r, dbx, dsx = direction(to_rows, to_rows, bias_x, scale_x, q.shape[2])
    dq_c, dk_c, dv_c, dby, dsy = direction(to_cols, from_cols, bias_y, scale_y, q.shape[1])
    return dq_r + dq_c, dk_r + dk_c, dv_r + dv_c, dbx, dby, dsx, dsy


def absent_as_none(grads, tables):
    """``grads`` of ``(bias_x, bias_y, scale_x, scale_y)``, None where the
    argument is absent."""
    return tuple(None if a is None else g for g, a in zip(grads, tables))


def fused_packed_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K6's forward; the arguments of
    :func:`fused_axial_attention_packed`."""
    dt, acc = q.dtype, accumulation_dtype(q.dtype)
    out = packed_attention_f32(q.to(acc), k.to(acc), v.to(acc), bias_x, bias_y, scale_x,
                               scale_y, dt)
    return out.to(dt)


def fused_packed_bwd_plain(
    do: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
) -> tuple:
    """Plain PyTorch version of K6's backward: explicit formulas
    (:func:`packed_attention_bwd`), no autograd.  Returns the gradients of
    ``(q, k, v, bias_x, bias_y, scale_x, scale_y)`` for the output gradient
    ``do``: ``dq``, ``dk``, ``dv`` rounded once to ``q.dtype``, the rest
    float32 (None where the argument is absent)."""
    dt, acc = q.dtype, accumulation_dtype(q.dtype)
    tables = (bias_x, bias_y, scale_x, scale_y)
    dq, dk, dv, *grads = packed_attention_bwd(do, q.to(acc), k.to(acc), v.to(acc), *tables, dt)
    return (dq.to(dt), dk.to(dt), dv.to(dt), *absent_as_none(grads, tables))


def split_args(q, k, v, tables, what: str, **more) -> tuple:
    """The envelope of K6 and K7 checked (q, k, v and ``more``, e.g. ``do``,
    of q's shape ``(BT, H, W, heads, d)``; q, k, v of one dtype; head dim 16
    or 64, lines of at most ``MAX_LINE`` tokens), and their float32 tables
    (:func:`~bubbleformer_tpu_torch.ops.axial_lane.line_tables`):
    ``(params, (bt, h, w, heads, d, c))``."""
    bt, h, w, heads, d = q.shape
    c = heads * d
    _build.check_shapes(what, k=(k, q.shape), v=(v, q.shape),
                        **{name: (t, q.shape) for name, t in more.items()})
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{what}: q, k, v are {q.dtype}, {k.dtype}, {v.dtype}")
    check_line_shape(what, q.shape, q.dtype, h, w, c, heads)
    return line_tables(*tables, heads, h, w, q.device, what), (bt, h, w, heads, d, c)


def split_fwd_cuda(q, k, v, bias_x, bias_y, scale_x, scale_y, *, packed: bool,
                   what: str) -> torch.Tensor:
    """Launch the forward of ``csrc/axial_fused.cu`` (rows, then columns) in
    the kPacked (K6) or the kFused (K7) flavour: ``(BT, H, W, heads, d)``."""
    p, (bt, h, w, heads, d, c) = split_args(q, k, v, (bias_x, bias_y, scale_x, scale_y), what)
    dev = q.device
    qkv3 = torch.stack([q, k, v]).contiguous()
    row_out = torch.empty(bt, h, w, c, device=dev)
    out = torch.empty(bt, h, w, c, device=dev, dtype=q.dtype)
    lib = _build.library()
    err = lib.bf_axial_fused_fwd(
        _build.DTYPE_CODES[q.dtype], d, int(packed), qkv3.data_ptr(), p["bias_x"].data_ptr(),
        p["bias_y"].data_ptr(), p["scale"].data_ptr(), row_out.data_ptr(), out.data_ptr(), bt, h,
        w, c, heads, _build.stream_handle(dev),
    )
    _build.check(lib, err, f"{what} (bf_axial_fused_fwd)")
    return out.reshape(q.shape)


def split_bwd_cuda(do, q, k, v, bias_x, bias_y, scale_x, scale_y, *, packed: bool,
                   what: str) -> tuple:
    """Launch the backward of ``csrc/axial_fused.cu`` in either flavour: the
    gradients of ``(q, k, v, bias_x, bias_y, scale_x, scale_y)``, None where
    the argument is absent."""
    tables = (bias_x, bias_y, scale_x, scale_y)
    p, (bt, h, w, heads, d, c) = split_args(q, k, v, tables, what, do=do)
    dev, dt = q.device, q.dtype
    # Held by a name until the launches are queued.
    qkv3, do = torch.stack([q, k, v]).contiguous(), do.to(dt).contiguous()
    dqkv3 = torch.empty(3, bt, h, w, c, device=dev, dtype=dt)
    dacc = torch.empty(3, bt, h, w, c, device=dev) if packed else None
    stats = torch.empty(bt, heads, h * w, 3, device=dev) if max(h, w) > LINE_TILE else None
    dbx = torch.empty(heads, w, w, device=dev)
    dby = torch.empty(heads, h, h, device=dev)
    dscale = torch.empty(heads, 2, device=dev)
    part, plan = line_bwd_scratch(bt, h, w, heads, d, dev, ln=False)
    lib = _build.library()
    err = lib.bf_axial_fused_bwd(
        _build.DTYPE_CODES[dt], d, int(packed), qkv3.data_ptr(), do.data_ptr(),
        p["bias_x"].data_ptr(), p["bias_y"].data_ptr(), p["scale"].data_ptr(), dqkv3.data_ptr(),
        None if dacc is None else dacc.data_ptr(), None if stats is None else stats.data_ptr(),
        dbx.data_ptr(), dby.data_ptr(), dscale.data_ptr(), part.data_ptr(), *plan, bt, h, w, c,
        heads, _build.stream_handle(dev),
    )
    _build.check(lib, err, f"{what} (bf_axial_fused_bwd)")
    dq, dk, dv = (g.reshape(q.shape) for g in dqkv3)
    return (dq, dk, dv, *absent_as_none((dbx, dby, dscale[:, 0], dscale[:, 1]), tables))


def hopper_args(q, k, v, tables, what: str, do=None) -> tuple:
    """The bf16 Hopper kernels' arguments of K6 and K7: the envelope and
    tables of :func:`split_args`, q, k, v (then ``do``) read in place
    (:func:`~bubbleformer_tpu_torch._build.in_place_strides`, checked before
    anything reaches a card), and their strides as the C entries take them:
    ``(params, strides, (bt, h, w, heads, d, c))``."""
    more = {} if do is None else {"do": do}
    p, dims = split_args(q, k, v, tables, what, **more)
    if q.dtype != torch.bfloat16 or (do is not None and do.dtype != torch.bfloat16):
        raise TypeError(f"{what} takes bfloat16 q, k, v and do, not {q.dtype}"
                        + ("" if do is None else f" and {do.dtype}"))
    strides = _build.in_place_strides(what, q=q, k=k, v=v, **more)
    return p, _build.int64_array(strides), dims


def fused_packed_hopper_fwd(q, k, v, *tables) -> torch.Tensor:
    """K6's bf16 forward on the Hopper kernels (``csrc/lane_hopper.cuh``,
    ``Mode::kFusedPacked``; C entry ``bf_fused_packed_hopper_fwd``): q, k and
    v read in place, rows, then columns, the row pass's half of the output
    in a float32 scratch and the sum rounded once.  Counts
    ``fused_packed_hopper_fwd.launches``."""
    what = "fused_axial_attention_packed (bf_fused_packed_hopper_fwd)"
    p, strides, (bt, h, w, heads, d, c) = hopper_args(q, k, v, tables, what)
    dev = q.device
    half = torch.empty(bt, h, w, c, device=dev)
    out = torch.empty(bt, h, w, c, device=dev, dtype=q.dtype)
    lib = _build.library()
    err = lib.bf_fused_packed_hopper_fwd(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), strides, p["bias_x"].data_ptr(),
        p["bias_y"].data_ptr(), p["scale"].data_ptr(), half.data_ptr(), out.data_ptr(), bt, h, w,
        c, heads, _build.stream_handle(dev))
    _build.check(lib, err, what)
    fused_packed_hopper_fwd.launches += 1
    return out.reshape(q.shape)


def fused_packed_hopper_bwd(do, q, k, v, *tables) -> tuple:
    """K6's bf16 backward on the Hopper kernels (C entry
    ``bf_fused_packed_hopper_bwd``): q, k, v and ``do`` read in place, one
    launch a direction, the row pass's ``d(q, k, v)`` in a float32 scratch,
    the column pass adding its own and rounding ``dq``, ``dk``, ``dv`` once;
    then one launch that adds the blocks' table and scale partials in a
    fixed order.  The gradients :func:`fused_packed_bwd_plain` returns;
    counts ``fused_packed_hopper_bwd.launches``."""
    what = "fused_axial_attention_packed_bwd (bf_fused_packed_hopper_bwd)"
    p, strides, (bt, h, w, heads, d, c) = hopper_args(q, k, v, tables, what, do=do)
    dev = q.device
    dqkv3 = torch.empty(3, bt, h, w, c, device=dev, dtype=q.dtype)
    dacc = torch.empty(bt, h, w, 3 * c, device=dev)
    part, plan = lane_bwd_scratch(bt, h, w, heads, d, dev, MODE_FUSED_PACKED)
    dbx, dby = torch.empty(heads, w, w, device=dev), torch.empty(heads, h, h, device=dev)
    dscale = torch.empty(heads, 2, device=dev)
    lib = _build.library()
    err = lib.bf_fused_packed_hopper_bwd(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), strides,
        p["bias_x"].data_ptr(), p["bias_y"].data_ptr(), p["scale"].data_ptr(),
        dqkv3[0].data_ptr(), dqkv3[1].data_ptr(), dqkv3[2].data_ptr(), dacc.data_ptr(),
        part.data_ptr(), dbx.data_ptr(), dby.data_ptr(), dscale.data_ptr(), bt, h, w, c, heads,
        *plan, _build.stream_handle(dev))
    _build.check(lib, err, what)
    fused_packed_hopper_bwd.launches += 1
    dq, dk, dv = (g.reshape(q.shape) for g in dqkv3)
    return (dq, dk, dv, *absent_as_none((dbx, dby, dscale[:, 0], dscale[:, 1]), tables))


def float32_only(q: torch.Tensor, what: str, hopper: str) -> None:
    """The float32 paths of K6 and K7 on the line kernels: bfloat16 runs the
    Hopper kernels ``hopper`` (``_fwd``/``_bwd``)."""
    if q.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 (bfloat16 runs {hopper}_fwd and {hopper}_bwd), "
                        f"not {q.dtype}")


def fused_packed_line_fwd(q, k, v, *tables) -> torch.Tensor:
    """K6's float32 forward on the line kernels (``csrc/axial_fused.cu``,
    kPacked); counts ``fused_packed_line_fwd.launches``."""
    float32_only(q, "fused_packed_line_fwd", "fused_packed_hopper")
    out = split_fwd_cuda(q, k, v, *tables, packed=True, what="fused_axial_attention_packed")
    fused_packed_line_fwd.launches += 1
    return out


def fused_packed_line_bwd(do, q, k, v, *tables) -> tuple:
    """K6's float32 backward on the line kernels (the row pass keeps float32
    gradients, the column pass adds its own and rounds; the table and scale
    gradients from per-line partials added in a fixed order); counts
    ``fused_packed_line_bwd.launches``."""
    float32_only(q, "fused_packed_line_bwd", "fused_packed_hopper")
    grads = split_bwd_cuda(do, q, k, v, *tables, packed=True,
                           what="fused_axial_attention_packed_bwd")
    fused_packed_line_bwd.launches += 1
    return grads


fused_packed_hopper_fwd.launches = fused_packed_hopper_bwd.launches = 0
fused_packed_line_fwd.launches = fused_packed_line_bwd.launches = 0


def fused_packed_kernels(dtype: torch.dtype) -> tuple:
    """K6's ``(forward, backward)`` kernels on the card for ``dtype``: the
    Hopper kernels for bfloat16, the line kernels for float32; any other
    dtype raises."""
    if dtype == torch.bfloat16:
        return fused_packed_hopper_fwd, fused_packed_hopper_bwd
    if dtype == torch.float32:
        return fused_packed_line_fwd, fused_packed_line_bwd
    raise TypeError(f"fused_axial_attention_packed kernel takes float32 or bfloat16, not {dtype}")


def _packed_fwd(q, k, v, *tables):
    if q.device.type == "cpu":
        return fused_packed_plain(q, k, v, *tables)
    if q.device.type != "cuda":
        raise ValueError(f"fused_axial_attention_packed: unsupported device {q.device}")
    out = fused_packed_kernels(q.dtype)[0](q, k, v, *tables)
    fused_axial_attention_packed.launches += 1
    return out


def fused_axial_attention_packed_bwd(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, *tables) -> tuple:
    """K6's backward: the gradients :func:`fused_packed_bwd_plain` returns.

    CPU tensors take :func:`fused_packed_bwd_plain`; CUDA tensors the kernels
    :func:`fused_packed_kernels` picks by dtype (bfloat16
    :func:`fused_packed_hopper_bwd`, float32 :func:`fused_packed_line_bwd`)
    and count ``fused_axial_attention_packed_bwd.launches``.  The table and
    scale gradients come from per-block partials added in a fixed order:
    they repeat bit for bit."""
    if q.device.type == "cpu":
        return fused_packed_bwd_plain(do, q, k, v, *tables)
    if q.device.type != "cuda":
        raise ValueError(f"fused_axial_attention_packed_bwd: unsupported device {q.device}")
    grads = fused_packed_kernels(q.dtype)[1](do.to(q.dtype), q, k, v, *tables)
    fused_axial_attention_packed_bwd.launches += 1
    return grads


def fused_axial_attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Averaged row/column attention ``(BT, H, W, heads, d)`` from qk-normed
    ``q``, ``k`` and ``v`` of that shape (float32 or bfloat16, one dtype),
    differentiable in every argument.

    ``bias_x`` ``(heads, W, W)`` / ``bias_y`` ``(heads, H, H)``: the T5
    tables; ``scale_x`` / ``scale_y`` ``(heads,)``: per-axis attn_scale.  CPU
    tensors take the plain versions; CUDA tensors launch the kernels
    (``fused_axial_attention_packed.launches`` and
    ``fused_axial_attention_packed_bwd.launches`` count them)."""
    return LineAttention.apply(_packed_fwd, fused_axial_attention_packed_bwd, {}, q, k, v,
                               bias_x, bias_y, scale_x, scale_y)


fused_axial_attention_packed.launches = 0
fused_axial_attention_packed_bwd.launches = 0
