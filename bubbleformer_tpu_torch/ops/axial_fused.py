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
tensors its forward and backward launch hand-written kernels, chosen by
dtype and line length in one place (:func:`fused_kernels`): bfloat16 runs
K8's Hopper kernels over the rows and then the columns of the plane
(``csrc/flash_hopper.cuh``, kPlane; C entries ``csrc/axial_flash_hopper.cu``:
q, k, v and ``do`` read in place with their own strides, ``P_eff`` and
``dS`` split into bf16 pairs, the row pass's rounded half and gradients
added to the column pass's; :func:`fused_hopper_fwd`,
:func:`fused_hopper_bwd`, the blocks' segments planned by
:func:`fused_bwd_layout`); float32 runs the line kernels of
``csrc/axial_fused.cu`` in their kFused flavour (:func:`fused_line_fwd`,
:func:`fused_line_bwd`), and so does a bfloat16 backward whose lines the
Hopper backward does not stage (head dim 64, more than 256 tokens: a choice
by shape on the host, counted by ``fused_line_bwd.launches``).  Both take
head dims 16 and 64 and lines of up to 512 tokens (any other shape raises)
and sum the table and scale gradients in a fixed order: they repeat bit for
bit.  On CPU tensors :func:`fused_plain` and :func:`fused_bwd_plain`; on any
other device they raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.layers.norm import accumulation_dtype
from bubbleformer_tpu_torch.ops.attention import axis_attention, from_cols, to_cols, to_rows
from bubbleformer_tpu_torch.ops.axial_fused_packed import (
    absent_as_none,
    float32_only,
    hopper_args,
    split_bwd_cuda,
    split_fwd_cuda,
)
from bubbleformer_tpu_torch.ops.axial_lane import LineAttention
from bubbleformer_tpu_torch.ops.axial_pallas import (
    flash_bwd_plan,
    flash_hopper_bwd_fits,
    flash_rows,
)


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


def fused_bwd_layout(bt: int, h: int, w: int, heads: int, residents) -> tuple:
    """``(floats, plan)`` of K7's bf16 Hopper backward whose kernel keeps
    ``residents`` = (rows', columns') blocks on the card: each direction's
    plan of K8's (:func:`~bubbleformer_tpu_torch.ops.axial_pallas.
    flash_bwd_plan`: the rows are ``bt * h`` lines of ``w`` tokens, the
    columns ``bt * w`` lines of ``h``), ``plan`` = ``[groups_r, per_r,
    groups_c, per_c]``, and the size of one float32 buffer of both passes'
    partials, the rows' then the columns', each its tables ``(groups, heads,
    L, L)`` then its scales ``(heads, groups)``."""
    size, plan = 0, []
    for (m, n), resident in zip(((bt * h, w), (bt * w, h)), residents):
        floats, groups, per = flash_bwd_plan(m, n, heads, resident)
        size += floats
        plan += [groups, per]
    return size, plan


def fused_rows(bt: int, h: int, w: int, direction: int, seg: int) -> list:
    """The token (its index in the ``(BT, H, W)`` grid) of each staged row of
    segment ``seg`` of K7's rows (``direction`` 0: ``bt * h`` lines of ``w``
    tokens) or columns (1: ``bt * w`` lines of ``h``), None for an empty row,
    as ``csrc/flash_hopper.cuh: seg_rows`` and ``plane_token`` place them:
    K8's packing of lines (:func:`~bubbleformer_tpu_torch.ops.axial_pallas.
    flash_rows`) with a row's tokens 1 apart and a column's ``w`` apart."""
    m, n = (bt * h, w) if direction == 0 else (bt * w, h)
    return [None if cell is None else
            cell[0] * w + cell[1] if direction == 0 else
            cell[0] // w * h * w + cell[1] * w + cell[0] % w
            for cell in flash_rows(m, n, seg)]


@functools.lru_cache(maxsize=None)
def _fused_resident(index: int, head_dim: int, n: int) -> int:
    """Blocks of K7's Hopper backward for lines of ``n`` tokens that card
    ``index`` holds at once (C entry ``bf_fused_hopper_resident``)."""
    lib = _build.library()
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.bf_fused_hopper_resident(head_dim, n, ctypes.byref(per_sm))
    _build.check(lib, err, "bf_fused_hopper_resident")
    return torch.cuda.get_device_properties(index).multi_processor_count * max(1, per_sm.value)


def fused_hopper_fwd(q, k, v, *tables) -> torch.Tensor:
    """K7's bf16 forward on the Hopper kernels (``csrc/flash_hopper.cuh``,
    kPlane; C entry ``bf_fused_hopper_fwd``): q, k and v read in place, the
    rows' ``R(0.5 P_eff v)`` into a bf16 scratch, then the columns' added to
    it and rounded.  Counts ``fused_hopper_fwd.launches``."""
    what = "fused_axial_attention (bf_fused_hopper_fwd)"
    p, strides, (bt, h, w, heads, d, c) = hopper_args(q, k, v, tables, what)
    dev = q.device
    half = torch.empty(bt, h, w, c, device=dev, dtype=q.dtype)
    out = torch.empty_like(half)
    lib = _build.library()
    err = lib.bf_fused_hopper_fwd(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), strides, p["bias_x"].data_ptr(),
        p["bias_y"].data_ptr(), p["scale"].data_ptr(), half.data_ptr(), out.data_ptr(), bt, h, w,
        c, heads, _build.stream_handle(dev))
    _build.check(lib, err, what)
    fused_hopper_fwd.launches += 1
    return out.reshape(q.shape)


def fused_hopper_bwd(do, q, k, v, *tables) -> tuple:
    """K7's bf16 backward on the Hopper kernels (C entry
    ``bf_fused_hopper_bwd``): K8's backward on ``dao = 0.5 do`` over the rows,
    then the columns, q, k, v and ``do`` read in place, each direction's
    ``dq``, ``dk``, ``dv`` rounded and the columns' added to the rows'; then
    one launch that adds both directions' table and scale partials in a
    fixed order.  The gradients :func:`fused_bwd_plain` returns; counts
    ``fused_hopper_bwd.launches``."""
    what = "fused_axial_attention_bwd (bf_fused_hopper_bwd)"
    p, strides, (bt, h, w, heads, d, c) = hopper_args(q, k, v, tables, what, do=do)
    if not flash_hopper_bwd_fits(max(h, w), d):
        raise ValueError(f"{what} stages lines of at most 256 tokens at head dim 64 "
                         f"(fused_line_bwd takes longer ones); got q {tuple(q.shape)}")
    dev = q.device
    dqkv3 = torch.empty(3, bt, h, w, c, device=dev, dtype=q.dtype)
    floats, plan = fused_bwd_layout(bt, h, w, heads,
                                    [_fused_resident(dev.index, d, n) for n in (w, h)])
    part = torch.empty(floats, device=dev)
    dbx, dby = torch.empty(heads, w, w, device=dev), torch.empty(heads, h, h, device=dev)
    dscale = torch.empty(heads, 2, device=dev)
    lib = _build.library()
    err = lib.bf_fused_hopper_bwd(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), strides,
        p["bias_x"].data_ptr(), p["bias_y"].data_ptr(), p["scale"].data_ptr(),
        dqkv3[0].data_ptr(), dqkv3[1].data_ptr(), dqkv3[2].data_ptr(), part.data_ptr(),
        dbx.data_ptr(), dby.data_ptr(), dscale.data_ptr(), bt, h, w, c, heads, *plan,
        _build.stream_handle(dev))
    _build.check(lib, err, what)
    fused_hopper_bwd.launches += 1
    dq, dk, dv = (g.reshape(q.shape) for g in dqkv3)
    return (dq, dk, dv, *absent_as_none((dbx, dby, dscale[:, 0], dscale[:, 1]), tables))


def fused_line_fwd(q, k, v, *tables) -> torch.Tensor:
    """K7's float32 forward on the line kernels (``csrc/axial_fused.cu``,
    kFused); counts ``fused_line_fwd.launches``."""
    float32_only(q, "fused_line_fwd", "fused_hopper")
    out = split_fwd_cuda(q, k, v, *tables, packed=False, what="fused_axial_attention")
    fused_line_fwd.launches += 1
    return out


def fused_line_bwd(do, q, k, v, *tables) -> tuple:
    """K7's backward on the line kernels (``csrc/axial_fused.cu``, kFused:
    the row pass writes its rounded gradients, the column pass adds its own;
    the table and scale gradients from per-line partials added in a fixed
    order): float32, and bfloat16 lines the Hopper backward does not stage
    (:func:`fused_kernels`); counts ``fused_line_bwd.launches``."""
    if flash_hopper_bwd_fits(max(q.shape[1], q.shape[2]), q.shape[-1]):
        float32_only(q, "fused_line_bwd", "fused_hopper")
    grads = split_bwd_cuda(do, q, k, v, *tables, packed=False, what="fused_axial_attention_bwd")
    fused_line_bwd.launches += 1
    return grads


fused_hopper_fwd.launches = fused_hopper_bwd.launches = 0
fused_line_fwd.launches = fused_line_bwd.launches = 0


def fused_kernels(dtype: torch.dtype, n: int = 1, d: int = 64) -> tuple:
    """K7's ``(forward, backward)`` kernels on the card for ``dtype``, lines
    of at most ``n`` tokens (``max(H, W)``) and head dim ``d``: the Hopper
    kernels for bfloat16 (the backward while its lines fit,
    :func:`~bubbleformer_tpu_torch.ops.axial_pallas.flash_hopper_bwd_fits`,
    else the line kernels'), the line kernels for float32; any other dtype
    raises."""
    if dtype == torch.bfloat16:
        return fused_hopper_fwd, (fused_hopper_bwd if flash_hopper_bwd_fits(n, d)
                                  else fused_line_bwd)
    if dtype == torch.float32:
        return fused_line_fwd, fused_line_bwd
    raise TypeError(f"fused_axial_attention kernel takes float32 or bfloat16, not {dtype}")


def _fused_fwd(q, k, v, *tables):
    if q.device.type == "cpu":
        return fused_plain(q, k, v, *tables)
    if q.device.type != "cuda":
        raise ValueError(f"fused_axial_attention: unsupported device {q.device}")
    out = fused_kernels(q.dtype)[0](q, k, v, *tables)
    fused_axial_attention.launches += 1
    return out


def fused_axial_attention_bwd(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *tables) -> tuple:
    """K7's backward: the gradients :func:`fused_bwd_plain` returns.

    CPU tensors take :func:`fused_bwd_plain`; CUDA tensors the kernels
    :func:`fused_kernels` picks (bfloat16 :func:`fused_hopper_bwd`, or
    :func:`fused_line_bwd` on lines the Hopper backward does not stage;
    float32 :func:`fused_line_bwd`) and count
    ``fused_axial_attention_bwd.launches``.  The table and scale gradients
    come from per-block partials added in a fixed order: they repeat bit for
    bit."""
    if q.device.type == "cpu":
        return fused_bwd_plain(do, q, k, v, *tables)
    if q.device.type != "cuda":
        raise ValueError(f"fused_axial_attention_bwd: unsupported device {q.device}")
    bwd = fused_kernels(q.dtype, max(q.shape[1], q.shape[2]), q.shape[-1])[1]
    grads = bwd(do.to(q.dtype), q, k, v, *tables)
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
