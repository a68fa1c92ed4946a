"""K2: the axial row + column attention core, forward and backward.

Counterpart of ``bubbleformer_tpu/ops/axial_lane.py:
lane_axial_attention_from_x``: the QKV projection of the InstanceNorm1
output (a float32 ``addmm``, as it was XLA on the TPU,
``axial_lane.py:983-1000``), then per-head qk-LayerNorm, attention along
each row (over W, ``bias_x``, ``scale_x``) and each column (over H,
``bias_y``, ``scale_y``) with the attn_scale blend folded into the
probabilities, and the mean of the two directions.  With ``proj="kernel"``
(or ``BUBBLEFORMER_LANE_PROJ=kernel``, as in the JAX package) the projection
runs inside the kernels instead: K9, ``ops/axial_lane_px.py``.

:func:`lane_axial_attention` is a ``torch.autograd.Function``.  On CUDA
tensors its forward and backward launch hand-written kernels, chosen by
dtype in one place (:func:`lane_kernels`): bfloat16 runs the Hopper kernels
of ``csrc/lane_hopper.cuh`` (C entries ``csrc/axial_lane_hopper.cu``:
q, k and v staged in bf16, every product on the tensor cores, the row
pass's output in a bf16 scratch, one backward launch a direction and the
parameter gradients summed from per-block partials in a fixed order, so
they repeat bit for bit; :func:`lane_hopper_fwd`, :func:`lane_hopper_bwd`,
the blocks' lines planned by :func:`lane_bwd_plan`); float32 runs the line
kernels of ``csrc/axial_attention.cu`` in their lane flavour
(:func:`lane_line_fwd`, :func:`lane_line_bwd`).  On CPU tensors they take
:func:`axial_attention_plain` and :func:`axial_attention_bwd_plain`; on any
other device they raise.  Both kernel paths take head dims 16 and 64 and
lines of up to 512 tokens (the JAX lane gate's limit,
:func:`lane_axial_supported`); any other shape raises on the card, naming
it.  The line kernels in their fused_block flavour are K4 in float32
(``ops/axial_fused_block.py``), launched through
:func:`line_attention_fwd_cuda` and :func:`line_attention_bwd_cuda`; K4 in
bfloat16 runs these Hopper kernels in its own rounding.

Both round where the lane kernel rounds: qkv, q/k (after LN), the blended
probabilities and each direction's output in the activation dtype
(``axial_lane.py:_axis_fwd``, ``:844-848``).  In the backward each direction's
output gradient is ``dtype(0.5 * dout)``; the probability gradient ``dS`` is
rounded before its products with q and k, and the blended probabilities
before theirs with ``dao`` (``_axis_bwd :254-317``); each direction's
``dqkv`` is rounded to the activation dtype (``:700-701``) and the two are
added and rounded once more, since the port's QKV tensor is one tensor where
the TPU package projected once per direction.
"""
from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Optional

import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.layers import remat
from bubbleformer_tpu_torch.layers.linear import linear
from bubbleformer_tpu_torch.layers.norm import (
    accumulation_dtype,
    layer_norm_bwd,
    layer_norm_f32,
    row_xhat,
)
from bubbleformer_tpu_torch.ops.attention import axis_attention, from_cols, to_cols, to_rows

HEAD_DIMS = (16, 64)  # the kernels' compile-time head dims
MAX_LINE = 512  # longest row or column the kernels take
LINE_TILE = 64  # tokens per query or key tile (csrc/axial_attention.cu kTile)
# At most this many floats of the line kernels' backward table partials a
# pass (128 MB): long lines take fewer, longer runs of lines, and so more
# launches.
LINE_PARTIAL_FLOATS = 1 << 25
# Blocks of the line kernels' backward planned a multiprocessor
# (line_bwd_resident).
LINE_BLOCKS_PER_SM = 128
# The JAX lane gate's defaults: its chunk-lane target (BUBBLEFORMER_LANE_CHUNK
# unset, bubbleformer_tpu/ops/axial_lane.py:123) and its grid-step budget
# (BUBBLEFORMER_LANE_GRID unset, :92).  The port reads neither knob (it reads
# one of the module's: BUBBLEFORMER_LANE_PROJ, lane_axial_attention_from_x).
LANE_CHUNK_TARGET = 256
LANE_GRID_BUDGET = int(60e6)
# The modes of csrc/lane_hopper.cuh's bf16 backward kernel (its enum Mode), as
# the C entry bf_lane_bwd_resident takes them: K2's, K9's, K5's, K4's and K6's.
MODE_LANE, MODE_LANE_PX, MODE_MEGA, MODE_FUSED_BLOCK, MODE_FUSED_PACKED = 0, 1, 2, 3, 4


def axial_attention_plain(
    qkv: torch.Tensor, qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of K2's forward; the arguments of
    :func:`lane_axial_attention`."""
    bt, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    dt, acc = qkv.dtype, accumulation_dtype(qkv.dtype)
    q5 = qkv.reshape(bt, h, w, heads, 3, d)
    q = layer_norm_f32(q5[..., 0, :], qn_scale, qn_bias).to(dt)
    k = layer_norm_f32(q5[..., 1, :], kn_scale, kn_bias).to(dt)
    v = q5[..., 2, :]
    o_r = axis_attention(to_rows(q), to_rows(k), to_rows(v), bias_x, scale_x, fold_dtype=dt).to(dt)
    o_r = to_rows(o_r).reshape(bt, h, w, c)
    o_c = axis_attention(to_cols(q), to_cols(k), to_cols(v), bias_y, scale_y, fold_dtype=dt).to(dt)
    o_c = from_cols(o_c).reshape(bt, h, w, c)
    return (0.5 * (o_r.to(acc) + o_c.to(acc))).to(dt)


def axial_attention_bwd_plain(
    do: torch.Tensor, qkv: torch.Tensor, qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int,
) -> tuple:
    """Plain PyTorch version of K2's backward: explicit formulas, no autograd.

    Returns the gradients of ``(qkv, qn_scale, qn_bias, kn_scale, kn_bias,
    bias_x, bias_y, scale_x, scale_y)`` for the output gradient ``do``:
    ``dqkv`` in ``qkv.dtype``, the rest float32 (None where the argument is
    absent).  Per direction, with ``G = dao v^T``: ``dscale = sum (P - 1/L) G``,
    ``dS = P * (s G - rowsum(s G P))`` (the T5 table's gradient),
    ``dq = dtype(dS) k / sqrt(d)``, ``dk = dtype(dS)^T q / sqrt(d)`` and
    ``dv = dtype(s P + (1-s)/L)^T dao`` (``axial_lane.py:_axis_bwd``), then
    the qk-LN backward (``_qkln_bwd``).  Each direction's ``dqkv`` is rounded
    to ``qkv.dtype``; the two are added and rounded once more.
    """
    dqkv_r, dqkv_c, *rest = lane_bwd_directions(
        do, qkv, qn_scale, qn_bias, kn_scale, kn_bias, bias_x, bias_y, scale_x, scale_y,
        heads=heads)
    acc = accumulation_dtype(qkv.dtype)
    return ((dqkv_r.to(acc) + dqkv_c.to(acc)).to(qkv.dtype), *rest)


def lane_bwd_directions(do, qkv, qn_scale, qn_bias, kn_scale, kn_bias, bias_x=None,
                        bias_y=None, scale_x=None, scale_y=None, *, heads: int) -> tuple:
    """K2's backward kept apart by direction: ``(dqkv_rows, dqkv_cols,
    dqn_scale, dqn_bias, dkn_scale, dkn_bias, dbias_x, dbias_y, dscale_x,
    dscale_y)``, each direction's ``dqkv`` rounded to ``qkv.dtype``, the
    parameter gradients summed over both (float32, None where the argument is
    absent).  :func:`axial_attention_bwd_plain` adds the two ``dqkv``; K9
    projects each back on its own (``ops/axial_lane_px.py``)."""
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
        batch = (0, 1)
        dscale = ((p - 1.0 / length) * g).sum(dim=(0, 1, 3, 4))
        dp = s * g
        dlog = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dlog_r = dlog.to(dt).to(acc)
        dq = unfold((dlog_r @ ks) * d**-0.5)
        dk = unfold((dlog_r.transpose(-1, -2) @ qs) * d**-0.5)
        pb = (s * p + (1.0 - s) / length).to(dt).to(acc)
        dv = unfold(pb.transpose(-1, -2) @ ds)
        dqr, dgq, dbq = layer_norm_bwd(dq, qhat, qrstd, qn_scale)
        dkr, dgk, dbk = layer_norm_bwd(dk, khat, krstd, kn_scale)
        dqkv = torch.stack([dqr.to(dt), dkr.to(dt), dv.to(dt)], dim=-2).reshape(bt, h, w, c3)
        return dqkv, torch.stack([dgq, dbq, dgk, dbk]), dlog.sum(dim=batch), dscale

    dqkv_r, dln_r, dbx, dsx = direction(to_rows, to_rows, bias_x, scale_x, w)
    dqkv_c, dln_c, dby, dsy = direction(to_cols, from_cols, bias_y, scale_y, h)
    dln = dln_r + dln_c
    return (dqkv_r, dqkv_c, dln[0], dln[1], dln[2], dln[3],
            None if bias_x is None else dbx, None if bias_y is None else dby,
            None if scale_x is None else dsx, None if scale_y is None else dsy)


def lane_axial_supported(h: int, w: int, c: int, heads: int) -> bool:
    """The JAX package's shape gate for routing ``attn_impl="auto"`` to K2
    (``bubbleformer_tpu/ops/axial_lane.py:129-162``), copied: token count a
    multiple of 128, head dim a multiple of 8, lines of at most 512 tokens,
    and the TPU kernel's per-grid-step VMEM working set within its budget.
    The JAX module reads its chunk-lane target and a grid-step cap from
    ``BUBBLEFORMER_LANE_CHUNK`` and ``BUBBLEFORMER_LANE_GRID``; the port reads
    neither and keeps their defaults (``LANE_CHUNK_TARGET``, no cap)."""
    n = h * w
    d = c // heads
    if c % heads or n % 128 or d % 8:
        return False
    if max(h, w) > 512:
        return False
    gch = _grid_chunk(h, w, c, n)
    ch_r = _pick_chunk(w, gch)
    ch_c = _pick_chunk(h, gch)
    table_bytes = 8 * heads * (ch_r * ch_r + ch_c * ch_c)
    return 86 * c * gch + table_bytes <= int(100e6)


def _pick_chunk(blk: int, n: int) -> int:
    """A multiple of the window ``blk`` near ``LANE_CHUNK_TARGET`` lanes
    dividing ``n`` (``axial_lane.py:69-83``)."""
    nb = n // blk
    kk = min(max(1, LANE_CHUNK_TARGET // blk), nb)
    while nb % kk:
        kk -= 1
    return blk * kk


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def _grid_chunk(h: int, w: int, c: int, n: int) -> int:
    """Lanes per grid step of the TPU kernel (``axial_lane.py:92-115``, no
    cap): whole rows and whole columns, 128-aligned, within
    ``LANE_GRID_BUDGET``."""
    align = _lcm(_lcm(h, w), 128)
    if align >= n or n % align:
        return n
    nk = n // align
    k = max(1, min(nk, LANE_GRID_BUDGET // (86 * c * align)))
    while nk % k:
        k -= 1
    return align * k


def check_line_shape(what: str, shape, dtype, h: int, w: int, c: int, heads: int) -> int:
    """Raise unless the line kernels take this input (float32 or bfloat16,
    head dim 16 or 64, lines of at most ``MAX_LINE`` tokens), naming its
    shape; returns the head dim."""
    d = c // heads
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, not {dtype}")
    if c != heads * d or d not in HEAD_DIMS or max(h, w) > MAX_LINE:
        raise ValueError(
            f"{what} kernel takes head_dim in {HEAD_DIMS} and lines of at most {MAX_LINE} "
            f"tokens; got {tuple(shape)} ({h}x{w} tokens, C={c}, heads={heads})"
        )
    return d


def line_tables(bias_x, bias_y, scale_x, scale_y, heads: int, h: int, w: int, dev, what: str):
    """The line kernels' float32 tables and scales: ``bias_x`` ``(heads, W,
    W)``, ``bias_y`` ``(heads, H, H)`` (absent: zero) and ``scale`` ``(heads,
    2)`` = ``[s_x, s_y]`` (absent: one)."""

    def f32(a):
        return a.detach().to(device=dev, dtype=torch.float32).contiguous()

    ones = torch.ones(heads, device=dev)
    p = dict(
        bias_x=torch.zeros(heads, w, w, device=dev) if bias_x is None else f32(bias_x),
        bias_y=torch.zeros(heads, h, h, device=dev) if bias_y is None else f32(bias_y),
        scale=torch.stack([ones if scale_x is None else f32(scale_x),
                           ones if scale_y is None else f32(scale_y)], dim=1).contiguous(),
    )
    _build.check_shapes(what, bias_x=(p["bias_x"], (heads, w, w)),
                        bias_y=(p["bias_y"], (heads, h, h)), scale=(p["scale"], (heads, 2)))
    return p


def kernel_params(qkv, qn_scale, qn_bias, kn_scale, kn_bias, bias_x, bias_y, scale_x, scale_y,
                  heads, what):
    """The float32 parameter tensors of the line kernels (absent tables
    zero, absent scales one), after checking the kernels' envelope: head dim
    16 or 64, lines of at most ``MAX_LINE`` tokens."""
    bt, h, w, c3 = qkv.shape
    if c3 % 3:
        raise ValueError(f"{what}: qkv {tuple(qkv.shape)} is not (BT, H, W, 3C)")
    d = check_line_shape(what, qkv.shape, qkv.dtype, h, w, c3 // 3, heads)
    dev = qkv.device
    ln = torch.stack([a.detach().to(device=dev, dtype=torch.float32)
                      for a in (qn_scale, qn_bias, kn_scale, kn_bias)])
    _build.check_shapes(what, ln=(ln, (4, d)))
    return dict(ln=ln.contiguous(), **line_tables(bias_x, bias_y, scale_x, scale_y, heads, h, w,
                                                  dev, what))


def line_attention_fwd_cuda(qkv: torch.Tensor, *params, heads: int, fused: bool,
                            what: str) -> torch.Tensor:
    """Launch the forward of ``csrc/axial_attention.cu`` (rows, then columns)
    in the lane (K2) or the fused_block (K4) flavour; ``(BT, H, W, C)``."""
    bt, h, w, c3 = qkv.shape
    c = c3 // 3
    p = kernel_params(qkv, *params, heads, what)
    dev = qkv.device
    qkv = qkv.contiguous()
    row_out = torch.empty(bt, h, w, c, device=dev)
    out = torch.empty(bt, h, w, c, device=dev, dtype=qkv.dtype)
    lib = _build.library()
    err = lib.bf_axial_attention_fwd(
        _build.DTYPE_CODES[qkv.dtype], c // heads, int(fused), qkv.data_ptr(),
        p["ln"].data_ptr(), p["bias_x"].data_ptr(), p["bias_y"].data_ptr(),
        p["scale"].data_ptr(), row_out.data_ptr(), out.data_ptr(), bt, h, w, c, heads,
        _build.stream_handle(dev),
    )
    _build.check(lib, err, f"{what} (bf_axial_attention_fwd)")
    return out


def line_attention_bwd_cuda(do: torch.Tensor, qkv: torch.Tensor, *params, heads: int,
                            fused: bool, what: str) -> tuple:
    """Launch the backward of ``csrc/axial_attention.cu`` in either flavour:
    the gradients of ``(qkv, qn_scale, qn_bias, kn_scale, kn_bias, bias_x,
    bias_y, scale_x, scale_y)``, None where the argument is absent."""
    bt, h, w, c3 = qkv.shape
    c = c3 // 3
    p = kernel_params(qkv, *params, heads, what)
    _build.check_shapes(what, do=(do, (bt, h, w, c)))
    dev = qkv.device
    dqkv = torch.empty(bt, h, w, c3, device=dev, dtype=qkv.dtype)
    dacc = torch.empty(bt, h, w, c3, device=dev) if fused else None
    stats = torch.empty(bt, heads, h * w, 3, device=dev) if max(h, w) > LINE_TILE else None
    dln = torch.empty(4, c // heads, device=dev)
    dbx = torch.empty(heads, w, w, device=dev)
    dby = torch.empty(heads, h, h, device=dev)
    dscale = torch.empty(heads, 2, device=dev)
    part, plan = line_bwd_scratch(bt, h, w, heads, c // heads, dev)
    qkv, do = qkv.contiguous(), do.to(qkv.dtype).contiguous()  # held until queued
    lib = _build.library()
    err = lib.bf_axial_attention_bwd(
        _build.DTYPE_CODES[qkv.dtype], c // heads, int(fused), qkv.data_ptr(), do.data_ptr(),
        p["ln"].data_ptr(), p["bias_x"].data_ptr(), p["bias_y"].data_ptr(),
        p["scale"].data_ptr(), dqkv.data_ptr(), None if dacc is None else dacc.data_ptr(),
        None if stats is None else stats.data_ptr(), dln.data_ptr(), dbx.data_ptr(),
        dby.data_ptr(), dscale.data_ptr(), part.data_ptr(), *plan, bt, h, w, c, heads,
        _build.stream_handle(dev),
    )
    _build.check(lib, err, f"{what} (bf_axial_attention_bwd)")
    bias_x, bias_y, scale_x, scale_y = params[4:]
    return (dqkv, dln[0], dln[1], dln[2], dln[3],
            None if bias_x is None else dbx, None if bias_y is None else dby,
            None if scale_x is None else dscale[:, 0], None if scale_y is None else dscale[:, 1])


def line_bwd_plan(bt: int, h: int, w: int, heads: int, d: int, resident: int, *,
                  ln: bool = True, passes: int = 2) -> tuple:
    """``(floats, plan)`` of the line kernels' backward (``csrc/line_kernels.cuh:
    line_bwd_plans``) for a launch of at most ``resident`` blocks: pass p's
    ``bt * (h or w)`` lines fall into ``groups`` runs of ``per`` lines
    (:func:`lane_bwd_plan`), the kernels launched ``per`` times, a line of
    each run a launch, at most ``LINE_PARTIAL_FLOATS`` of table partials;
    ``plan`` = ``[groups_r, per_r, groups_c, per_c]``; ``floats`` is the size
    of the float32 buffer of the runs' partials, pass by pass: the table sums
    ``(groups, heads, L, L)``, the scale sums ``(heads, tiles * groups)`` and,
    where the kernels normalise q and k (``ln``), the LN sums ``(4 d, kernels
    * tiles * groups * heads)`` (two kernels for lines longer than a tile).
    K8 runs one pass (``passes=1``: ``bt = 1``, its M lines of n tokens as
    ``h`` and ``w``)."""
    size, plan = 0, []
    for length, lines in ((w, bt * h), (h, bt * w))[:passes]:
        tiles = -(-length // LINE_TILE)
        most = max(1, LINE_PARTIAL_FLOATS // (heads * length * length))  # groups' tables
        groups, per = lane_bwd_plan(lines, heads * tiles, min(resident, most * heads * tiles))
        kernels = 2 if length > LINE_TILE else 1
        size += groups * heads * (length * length + tiles
                                  + (kernels * tiles * 4 * d if ln else 0))
        plan += [groups, per]
    return size, plan + [0, 0] * (2 - passes)


def line_bwd_scratch(bt: int, h: int, w: int, heads: int, d: int, dev, *, ln: bool = True,
                     passes: int = 2) -> tuple:
    """``(part, plan)``: :func:`line_bwd_plan` on card ``dev``
    (:func:`line_bwd_resident`), its partials' buffer allocated."""
    size, plan = line_bwd_plan(bt, h, w, heads, d, line_bwd_resident(dev), ln=ln, passes=passes)
    return torch.empty(size, device=dev), plan


def line_bwd_resident(dev) -> int:
    """Blocks a launch of the line kernels' backward may have on card
    ``dev``: ``LINE_BLOCKS_PER_SM`` a multiprocessor, so that the runs of
    lines are short (a line each at FiLMAViT-small's and AViT-big's training
    shapes, as the kernels of one launch a pass had it) and each launch's
    last wave leaves little of the card idle: each further launch adds a
    partly idle wave (planned at 64 a multiprocessor, two launches a pass,
    the float32 K2 backward at AViT-big's shape read 6.8% above the kernels
    of one launch a pass; NVIDIA H100 80GB HBM3, 700.00 W).  A first level
    of the parameter sums inside the launch, over thread-block clusters or
    over runs of lines a block, read slower still (``PERF.md`` §6, PR 13)."""
    return LINE_BLOCKS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count


def lane_bwd_plan(lines: int, heads: int, resident: int) -> tuple:
    """``(groups, per)``: which block of K2's bf16 backward owns which lines
    of one direction.  Block ``g`` of a head takes the lines ``g * per`` to
    ``min((g + 1) * per, lines)``, one after another, and writes one partial
    of the table, scale and LN gradients; the partials are then added in
    block order.  At most one wave of the ``resident`` blocks the card holds
    at once (:func:`_resident_blocks`) and at least one block a head, every
    line in exactly one block and no block idle."""
    groups = max(1, min(lines, resident // heads))
    per = -(-lines // groups)
    return -(-lines // per), per


@functools.lru_cache(maxsize=None)
def _resident_blocks(index: int, head_dim: int, length: int, mode: int) -> int:
    """Blocks of the bf16 Hopper backward kernel of ``mode`` (``MODE_LANE``,
    ``MODE_LANE_PX``, ``MODE_MEGA``, ``MODE_FUSED_BLOCK`` or
    ``MODE_FUSED_PACKED``) for lines of
    ``length`` tokens that card ``index`` holds at once: its multiprocessors
    times the blocks one of them holds, as the CUDA runtime reads the
    kernel's registers, shared memory and block size (C entry
    ``bf_lane_bwd_resident``)."""
    lib = _build.library()
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.bf_lane_bwd_resident(mode, head_dim, length, ctypes.byref(per_sm))
    _build.check(lib, err, "bf_lane_bwd_resident")
    return torch.cuda.get_device_properties(index).multi_processor_count * max(1, per_sm.value)


def lane_bwd_layout(bt: int, h: int, w: int, heads: int, d: int, residents, *,
                    ln: bool = True) -> tuple:
    """``(floats, plan)`` of a bf16 Hopper backward of the lane kernels'
    family (K2's, K9's, K5's, K4's and K6's attention, ``csrc/lane_hopper.cuh:
    carve_partials``) whose kernels keep ``residents`` = (rows', columns')
    blocks on the card: the rows' and the columns' plans
    (:func:`lane_bwd_plan`), ``plan`` = ``[groups_r, per_r, groups_c,
    per_c]``, and the size of one float32 buffer of both passes' partials,
    each pass's table ``(groups, heads, L, L)``, scale ``(heads, groups)`` and,
    where the kernels normalise q and k (``ln``; not K6), LN ``(4, d, groups,
    heads)`` sums in that order."""
    size, plan = 0, []
    for (length, lines), resident in zip(((w, bt * h), (h, bt * w)), residents):
        groups, per = lane_bwd_plan(lines, heads, resident)
        size += groups * heads * (length * length + 1 + (4 * d if ln else 0))
        plan += [groups, per]
    return size, plan


def lane_bwd_scratch(bt: int, h: int, w: int, heads: int, d: int, dev, mode: int) -> tuple:
    """``(part, plan)``: :func:`lane_bwd_layout` over the blocks the kernel of
    ``mode`` keeps resident on card ``dev`` (:func:`_resident_blocks`), its
    partials' buffer allocated."""
    size, plan = lane_bwd_layout(bt, h, w, heads, d,
                                 [_resident_blocks(dev.index, d, n, mode) for n in (w, h)],
                                 ln=mode != MODE_FUSED_PACKED)
    return torch.empty(size, device=dev), plan


def lane_hopper_fwd(qkv: torch.Tensor, *params, heads: int) -> torch.Tensor:
    """K2's bf16 forward on the Hopper kernels (``csrc/lane_hopper.cuh``,
    C entry ``bf_lane_hopper_fwd``): rows, then columns; the row pass's
    output in a bf16 scratch, where the TPU kernel rounds it.  Counts
    ``lane_hopper_fwd.launches``."""
    bt, h, w, c3 = qkv.shape
    c = c3 // 3
    what = "lane_axial_attention (bf_lane_hopper_fwd)"
    p = kernel_params(qkv, *params, heads, what)
    qkv = qkv.contiguous()
    row_out = torch.empty(bt, h, w, c, device=qkv.device, dtype=qkv.dtype)
    out = torch.empty_like(row_out)
    _build.check_tma(what, qkv=qkv, row_out=row_out, out=out)
    lib = _build.library()
    err = lib.bf_lane_hopper_fwd(
        c // heads, qkv.data_ptr(), p["ln"].data_ptr(), p["bias_x"].data_ptr(),
        p["bias_y"].data_ptr(), p["scale"].data_ptr(), row_out.data_ptr(), out.data_ptr(), bt, h,
        w, c, heads, _build.stream_handle(qkv.device))
    _build.check(lib, err, what)
    lane_hopper_fwd.launches += 1
    return out


def lane_hopper_bwd(do: torch.Tensor, qkv: torch.Tensor, *params, heads: int) -> tuple:
    """K2's bf16 backward on the Hopper kernels (C entry
    ``bf_lane_hopper_bwd``): one launch a direction, then one that adds the
    blocks' partials (:func:`lane_bwd_plan`) in a fixed order, so the table,
    scale and LN gradients repeat bit for bit.  The gradients
    :func:`axial_attention_bwd_plain` returns; counts
    ``lane_hopper_bwd.launches``."""
    bt, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    what = "lane_axial_attention_bwd (bf_lane_hopper_bwd)"
    p = kernel_params(qkv, *params, heads, what)
    _build.check_shapes(what, do=(do, (bt, h, w, c)))
    dev = qkv.device
    qkv, do = qkv.contiguous(), do.to(qkv.dtype).contiguous()
    dqkv = torch.empty_like(qkv)
    _build.check_tma(what, qkv=qkv, do=do, dqkv=dqkv)
    part, plan = lane_bwd_scratch(bt, h, w, heads, d, dev, MODE_LANE)
    f32 = dict(device=dev, dtype=torch.float32)
    dln = torch.empty(4, d, **f32)
    dbx, dby = torch.empty(heads, w, w, **f32), torch.empty(heads, h, h, **f32)
    dscale = torch.empty(heads, 2, **f32)
    lib = _build.library()
    err = lib.bf_lane_hopper_bwd(
        d, qkv.data_ptr(), do.data_ptr(), p["ln"].data_ptr(), p["bias_x"].data_ptr(),
        p["bias_y"].data_ptr(), p["scale"].data_ptr(), dqkv.data_ptr(), part.data_ptr(),
        dln.data_ptr(), dbx.data_ptr(), dby.data_ptr(), dscale.data_ptr(), bt, h, w, c, heads,
        *plan, _build.stream_handle(dev))
    _build.check(lib, err, what)
    lane_hopper_bwd.launches += 1
    bias_x, bias_y, scale_x, scale_y = params[4:]
    return (dqkv, dln[0], dln[1], dln[2], dln[3],
            None if bias_x is None else dbx, None if bias_y is None else dby,
            None if scale_x is None else dscale[:, 0], None if scale_y is None else dscale[:, 1])


def _float32_only(qkv: torch.Tensor, what: str) -> None:
    """The line kernels' lane flavour is built in float32 alone: bfloat16 K2
    runs the Hopper kernels (:func:`lane_kernels`)."""
    if qkv.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 (bfloat16 runs lane_hopper_fwd and "
                        f"lane_hopper_bwd), not {qkv.dtype}")


def lane_line_fwd(qkv: torch.Tensor, *params, heads: int) -> torch.Tensor:
    """K2's float32 forward on the line kernels (lane flavour of
    ``csrc/line_kernels.cuh``); counts ``lane_line_fwd.launches``."""
    _float32_only(qkv, "lane_line_fwd")
    out = line_attention_fwd_cuda(qkv, *params, heads=heads, fused=False,
                                  what="lane_axial_attention")
    lane_line_fwd.launches += 1
    return out


def lane_line_bwd(do: torch.Tensor, qkv: torch.Tensor, *params, heads: int) -> tuple:
    """K2's float32 backward on the line kernels (per direction one launch
    for lines of at most 64 tokens, two for longer ones; the parameter
    gradients from per-block partials added in a fixed order, so they repeat
    bit for bit); counts ``lane_line_bwd.launches``."""
    _float32_only(qkv, "lane_line_bwd")
    grads = line_attention_bwd_cuda(do, qkv, *params, heads=heads, fused=False,
                                    what="lane_axial_attention_bwd")
    lane_line_bwd.launches += 1
    return grads


lane_hopper_fwd.launches = lane_hopper_bwd.launches = 0
lane_line_fwd.launches = lane_line_bwd.launches = 0


def lane_kernels(dtype: torch.dtype) -> tuple:
    """K2's ``(forward, backward)`` kernels on the card for ``dtype``: the
    Hopper kernels for bfloat16, the line kernels for float32; any other
    dtype raises."""
    if dtype == torch.bfloat16:
        return lane_hopper_fwd, lane_hopper_bwd
    if dtype == torch.float32:
        return lane_line_fwd, lane_line_bwd
    raise TypeError(f"lane_axial_attention kernel takes float32 or bfloat16, not {dtype}")


def lane_axial_attention_bwd(do: torch.Tensor, qkv: torch.Tensor, *params,
                             heads: int) -> tuple:
    """K2's backward: the gradients :func:`axial_attention_bwd_plain` returns.

    CPU tensors take :func:`axial_attention_bwd_plain`; CUDA tensors the
    kernels :func:`lane_kernels` picks by dtype (bfloat16
    :func:`lane_hopper_bwd`, whose parameter gradients repeat bit for bit;
    float32 :func:`lane_line_bwd`), and count
    ``lane_axial_attention_bwd.launches``."""
    if qkv.device.type == "cpu":
        return axial_attention_bwd_plain(do, qkv, *params, heads=heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"lane_axial_attention_bwd: unsupported device {qkv.device}")
    grads = lane_kernels(qkv.dtype)[1](do, qkv, *params, heads=heads)
    lane_axial_attention_bwd.launches += 1
    return grads


def _lane_fwd(qkv, *params, heads):
    if qkv.device.type == "cpu":
        return axial_attention_plain(qkv, *params, heads=heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"lane_axial_attention: unsupported device {qkv.device}")
    out = lane_kernels(qkv.dtype)[0](qkv, *params, heads=heads)
    lane_axial_attention.launches += 1
    return out


class LineAttention(torch.autograd.Function):
    """One flavour of the line kernels (K2, K4, K6, K7, K8, K9) as an autograd
    Function: ``fwd(*args, **kwargs)`` and ``bwd(do, *args, **kwargs)`` take
    the plain version on CPU tensors and launch the kernel on CUDA tensors;
    absent (None) arguments get no gradient."""

    @staticmethod
    def forward(ctx, fwd, bwd, kwargs, *args):
        ctx.bwd, ctx.kwargs = bwd, kwargs
        ctx.absent = tuple(a is None for a in args)
        ctx.save_for_backward(*(a for a in args if a is not None))
        # The JAX VJPs of these kernels keep only their inputs: remat "dots"
        # keeps the output and the block's rerun does not launch again.
        return remat.reuse(lambda: fwd(*args, **kwargs), site=fwd)

    @staticmethod
    def backward(ctx, do):
        saved = list(ctx.saved_tensors)
        args = [None if absent else saved.pop(0) for absent in ctx.absent]
        grads = ctx.bwd(do, *args, **ctx.kwargs)
        return (None, None, None, *(None if g is None else g.to(a.dtype)
                                    for g, a in zip(grads, args)))


def lane_axial_attention(
    qkv: torch.Tensor, qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int,
) -> torch.Tensor:
    """Averaged row/column attention ``(BT, H, W, C)`` from the interleaved
    QKV tensor ``qkv`` ``(BT, H, W, 3C)`` (float32 or bfloat16),
    differentiable in every argument.

    ``bias_x`` ``(heads, W, W)`` / ``bias_y`` ``(heads, H, H)``: the T5
    tables; ``scale_x`` / ``scale_y`` ``(heads,)``: per-axis attn_scale.
    CPU tensors take the plain versions; CUDA tensors launch the kernels
    of :func:`lane_kernels` (``lane_axial_attention.launches`` and
    ``lane_axial_attention_bwd.launches`` count every call on the card; each
    path's own counters count its launches).
    """
    return LineAttention.apply(_lane_fwd, lane_axial_attention_bwd, {"heads": heads}, qkv,
                               qn_scale, qn_bias, kn_scale, kn_bias, bias_x, bias_y, scale_x,
                               scale_y)


lane_axial_attention.launches = 0
lane_axial_attention_bwd.launches = 0


def project_qkv(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor) -> torch.Tensor:
    """``(x @ dtype(W)^T + b)`` accumulated and biased in float32 (float64 for
    float64 input), then rounded to ``x.dtype`` — the lane wrapper's XLA
    projection (``axial_lane.py:988-994``), one ``addmm`` that remat
    ``"dots"`` keeps."""
    acc = accumulation_dtype(x.dtype)
    y = linear(x.reshape(-1, x.shape[-1]).to(acc), wqkv.to(x.dtype).to(acc), bqkv.to(acc))
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)


def lane_axial_attention_from_x(
    x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
    qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int, proj: Optional[str] = None,
) -> torch.Tensor:
    """Axial attention from the InstanceNorm1 output ``x`` ``(BT, H, W, C)``:
    the QKV projection (``wqkv`` torch ``(3C, C)``), then
    :func:`lane_axial_attention`.

    ``proj``: where the projection runs; None reads
    ``BUBBLEFORMER_LANE_PROJ`` (default ``"xla"``), as the JAX function does
    (``axial_lane.py:932-933``).  ``"kernel"`` takes K9
    (:func:`~bubbleformer_tpu_torch.ops.axial_lane_px.lane_px_attention`:
    the projection inside the kernels, nothing 3C wide kept for the
    backward); any other value this route."""
    if proj is None:
        proj = os.environ.get("BUBBLEFORMER_LANE_PROJ", "xla")
    if proj == "kernel":
        from bubbleformer_tpu_torch.ops.axial_lane_px import lane_px_attention

        return lane_px_attention(x, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias, bias_x,
                                 bias_y, scale_x, scale_y, heads=heads)
    return lane_axial_attention(
        project_qkv(x, wqkv, bqkv), qn_scale, qn_bias, kn_scale, kn_bias,
        bias_x, bias_y, scale_x, scale_y, heads=heads,
    )
