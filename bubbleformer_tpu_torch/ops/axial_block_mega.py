"""K5: the whole axial-attention branch, forward and backward.

Counterpart of ``bubbleformer_tpu/ops/axial_block_mega.py:mega_axial_block``
(the ``mega`` route of the axial block): for each of the BT images,

    out = Dense(IN2(axial(qkLN(Dense(IN1(x))))))

with the residual and the block's epilogue left to the caller.  It rounds
where the TPU kernel rounds (``axial_block_mega.py:159-190``): IN1 single
pass in float32 with ``xn`` rounded to the activation dtype; ``W_qkv``
rounded to the activation dtype (``:586``), the product accumulated in
float32 and ``qkv + b_qkv`` rounded; qk-LN in float32, rounded; the
attention of K4 (``ops/axial_fused_block.py``: ``P`` rounded before its
product with ``v``, ``pv``, the window mean and the direction sum in
float32) with its output ``ao`` kept in float32 into IN2; ``y2`` rounded,
``W_out`` in the activation dtype (``:590``) and ``b_out`` added in float32
before the last rounding.  In the backward, ``dao = dtype(IN2 backward)``
goes through K4's attention backward (f32 sums of both directions, the
qk-LN backward, ``dqkv`` rounded once); every parameter gradient is float32.

The backward recomputes InstanceNorm2 — its statistics, ``xhat2`` and
``y2`` — from ``ao`` rounded to the activation dtype, the residual the TPU
kernel writes (``:182``, ``:236``), as the TPU kernel does; the forward
normalised the float32 ``ao``.  In bfloat16 the backward is therefore not
exactly the gradient of the forward, but it is the JAX kernel's: with the
float32 ``ao``, as the port's K1 keeps it, the bfloat16 parity test against
the JAX kernel failed (ROADMAP.md, Queue 3).

:func:`mega_axial_block` is a ``torch.autograd.Function``.  On CUDA tensors
its forward and backward launch ``csrc/axial_block_mega.cu``
(:func:`mega_axial_block_fwd`, :func:`mega_axial_block_bwd`: head dims 16 and
64, lines of up to 512 tokens, C a multiple of 32; any other shape raises),
chosen by dtype in one place (:func:`mega_kernels`): bfloat16 runs K1's
Hopper chain with the axial attention in its middle (:func:`mega_hopper_fwd`,
:func:`mega_hopper_bwd`: the products on the TMA + wgmma GEMM of
``csrc/hopper_gemm.cuh``, the attention on the tensor-core kernels of
``csrc/lane_hopper.cuh`` in K4's rounding, every parameter gradient in a
fixed order, so it repeats bit for bit); float32 keeps the first chain
(:func:`mega_line_fwd`, :func:`mega_line_bwd`: block_gemm.cuh's FMA tile and
the line kernels).  On CPU tensors :func:`mega_axial_plain` and
:func:`mega_axial_bwd_plain`; on any other device they raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.layers.norm import accumulation_dtype
from bubbleformer_tpu_torch.ops.axial_fused_block import fused_block_bwd_plain, fused_block_f32
from bubbleformer_tpu_torch.ops.axial_lane import (
    LINE_TILE,
    MODE_MEGA,
    check_line_shape,
    lane_bwd_scratch,
    line_bwd_scratch,
    line_tables,
)
from bubbleformer_tpu_torch.ops.hopper_gemm import split_k_plan
from bubbleformer_tpu_torch.ops.temporal_block_mega import plane_norm_bwd, plane_xhat

# Argument names after ``x``, in the order every function here takes them.
PARAM_NAMES = ("in1_scale", "in1_bias", "wqkv", "bqkv", "qn_scale", "qn_bias", "kn_scale",
               "kn_bias", "in2_scale", "in2_bias", "wout", "bout", "bias_x", "bias_y", "scale_x",
               "scale_y")


def _forward(x, in1_scale, in1_bias, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias,
             in2_scale, in2_bias, wout, bout, bias_x, bias_y, scale_x, scale_y, heads):
    """The forward at its rounding points, keeping what the backward needs;
    every tensor in the accumulation dtype (holding activation-dtype values
    where the kernel rounds) but ``qkv``, in the activation dtype.  ``ao``
    is unrounded."""
    bt, h, w, c = x.shape
    dt, acc = x.dtype, accumulation_dtype(x.dtype)
    r = dict(w1=wqkv.to(dt).to(acc), w2=wout.to(dt).to(acc))
    r["xhat1"], r["rstd1"] = plane_xhat(x.to(acc).reshape(bt, 1, h * w, c))
    r["xn"] = (r["xhat1"] * in1_scale.to(acc) + in1_bias.to(acc)).to(dt).to(acc)
    r["qkv"] = (r["xn"] @ r["w1"].t() + bqkv.to(acc)).to(dt).reshape(bt, h, w, 3 * c)
    r["ao"] = fused_block_f32(r["qkv"], qn_scale, qn_bias, kn_scale, kn_bias, bias_x, bias_y,
                              scale_x, scale_y, heads=heads).reshape(bt, 1, h * w, c)
    xhat2, _ = plane_xhat(r["ao"])
    y2 = (xhat2 * in2_scale.to(acc) + in2_bias.to(acc)).to(dt).to(acc)
    r["out"] = y2 @ r["w2"].t() + bout.to(acc)
    return r


def mega_axial_plain(
    x: torch.Tensor, in1_scale: torch.Tensor, in1_bias: torch.Tensor,
    wqkv: torch.Tensor, bqkv: torch.Tensor,
    qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    in2_scale: torch.Tensor, in2_bias: torch.Tensor,
    wout: torch.Tensor, bout: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of K5's forward; the arguments of
    :func:`mega_axial_block`."""
    r = _forward(x, in1_scale, in1_bias, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias,
                 in2_scale, in2_bias, wout, bout, bias_x, bias_y, scale_x, scale_y, heads)
    return r["out"].to(x.dtype).reshape(x.shape)


def mega_axial_bwd_plain(
    do: torch.Tensor, x: torch.Tensor, in1_scale: torch.Tensor, in1_bias: torch.Tensor,
    wqkv: torch.Tensor, bqkv: torch.Tensor,
    qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    in2_scale: torch.Tensor, in2_bias: torch.Tensor,
    wout: torch.Tensor, bout: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int,
) -> tuple:
    """Plain PyTorch version of K5's backward: explicit formulas, no autograd.

    Recomputes the forward from ``x`` and returns the gradients of
    ``(x, *PARAM_NAMES)`` for the output gradient ``do``: ``dx`` in
    ``x.dtype``, the rest float32 (None for an absent table or scale).  The
    output Dense and IN2 backward (IN2 recomputed from ``dtype(ao)``, as the
    TPU kernel does), ``dao`` rounded to the activation dtype, K4's attention
    backward
    (:func:`~bubbleformer_tpu_torch.ops.axial_fused_block.
    fused_block_bwd_plain`), then the QKV Dense and IN1 backward.
    """
    bt, h, w, c = x.shape
    dt, acc = x.dtype, accumulation_dtype(x.dtype)
    r = _forward(x, in1_scale, in1_bias, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias,
                 in2_scale, in2_bias, wout, bout, bias_x, bias_y, scale_x, scale_y, heads)
    xhat2, rstd2 = plane_xhat(r["ao"].to(dt).to(acc))
    y2 = (xhat2 * in2_scale.to(acc) + in2_bias.to(acc)).to(dt).to(acc)
    dof = do.to(acc).reshape(bt, 1, h * w, c)
    dwout = dof.reshape(-1, c).t() @ y2.reshape(-1, c)
    dbout = dof.sum(dim=(0, 1, 2))
    dao, din2_scale, din2_bias = plane_norm_bwd(dof @ r["w2"], xhat2, rstd2, in2_scale)
    dqkv, *attn = fused_block_bwd_plain(dao.to(dt).reshape(bt, h, w, c), r["qkv"], qn_scale,
                                        qn_bias, kn_scale, kn_bias, bias_x, bias_y, scale_x,
                                        scale_y, heads=heads)
    dqkv = dqkv.to(acc).reshape(bt, 1, h * w, 3 * c)
    dwqkv = dqkv.reshape(-1, 3 * c).t() @ r["xn"].reshape(-1, c)
    dbqkv = dqkv.sum(dim=(0, 1, 2))
    dx, din1_scale, din1_bias = plane_norm_bwd(dqkv @ r["w1"], r["xhat1"], r["rstd1"],
                                               in1_scale)
    return (dx.to(dt).reshape(x.shape), din1_scale, din1_bias, dwqkv, dbqkv, *attn[:4],
            din2_scale, din2_bias, dwout, dbout, *attn[4:])


def _check_kernel_shapes(what, x, heads):
    """The kernels' envelope: the line kernels' (head dim 16 or 64, lines of
    at most 512 tokens) and C a multiple of 32 (the GEMM tile's K chunk);
    returns the head dim."""
    bt, h, w, c = x.shape
    d = check_line_shape(what, x.shape, x.dtype, h, w, c, heads)
    if c % 32:
        raise ValueError(f"{what} kernel needs C % 32 == 0; got x {tuple(x.shape)}")
    return d


def _kernel_params(x, in1_scale, in1_bias, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias,
                   in2_scale, in2_bias, wout, bout, bias_x, bias_y, scale_x, scale_y, heads,
                   what):
    """K5's parameters as its C entries take them, in their order: float32
    vectors, the weights in the activation dtype, the qk-LN vectors stacked,
    the tables and scales of the line kernels."""
    bt, h, w, c = x.shape
    dev, dt = x.device, x.dtype

    def f32(a):
        return a.detach().to(device=dev, dtype=torch.float32).contiguous()

    p = dict(in1_w=f32(in1_scale), in1_b=f32(in1_bias),
             wqkv=wqkv.detach().to(device=dev, dtype=dt).contiguous(), bqkv=f32(bqkv),
             ln=torch.stack([f32(a) for a in (qn_scale, qn_bias, kn_scale, kn_bias)]),
             in2_w=f32(in2_scale), in2_b=f32(in2_bias),
             wout=wout.detach().to(device=dev, dtype=dt).contiguous(), bout=f32(bout),
             **line_tables(bias_x, bias_y, scale_x, scale_y, heads, h, w, dev, what))
    _build.check_shapes(
        what, in1_scale=(p["in1_w"], (c,)), in1_bias=(p["in1_b"], (c,)),
        wqkv=(p["wqkv"], (3 * c, c)), bqkv=(p["bqkv"], (3 * c,)), ln=(p["ln"], (4, c // heads)),
        in2_scale=(p["in2_w"], (c,)), in2_bias=(p["in2_b"], (c,)), wout=(p["wout"], (c, c)),
        bout=(p["bout"], (c,)))
    return p


def _check_residuals(what, x, residuals):
    """The forward kernels' residuals ``(stats1, qkv, ao_r)`` for ``x``."""
    bt, h, w, c = x.shape
    r = bt * h * w
    if residuals is None:
        raise ValueError(f"{what} on CUDA needs the forward kernels' residuals")
    stats1, qkv, ao_r = residuals
    _build.check_shapes(what, qkv=(qkv, (r, 3 * c)), ao=(ao_r, (r, c)),
                        stats1=(stats1, (2, bt, c)))
    if qkv.dtype != x.dtype or ao_r.dtype != x.dtype:
        raise TypeError(f"{what}: residuals qkv {qkv.dtype} and ao {ao_r.dtype}, "
                        f"x is {x.dtype}")
    return stats1, qkv, ao_r


def _grad_buffers(x, heads: int, zero: bool) -> dict:
    """dx in x's dtype and the float32 parameter gradients, in the C
    entries' order (zeroed where the float32 chain adds into them)."""
    bt, h, w, c = x.shape
    dev = x.device
    new = torch.zeros if zero else torch.empty
    f32 = dict(device=dev, dtype=torch.float32)
    return dict(dx=torch.empty(x.shape, device=dev, dtype=x.dtype), din1=new(2, c, **f32),
                dwqkv=new(3 * c, c, **f32), dbqkv=new(3 * c, **f32),
                dln=torch.empty(4, c // heads, **f32), din2=new(2, c, **f32),
                dwout=new(c, c, **f32), dbout=new(c, **f32),
                dbx=torch.empty(heads, w, w, **f32), dby=torch.empty(heads, h, h, **f32),
                dscale=torch.empty(heads, 2, **f32))


def _grads(g: dict, params) -> tuple:
    """The backward's outputs in the order of ``(x, *PARAM_NAMES)``, None
    for an absent table or scale."""
    tables = params[-4:]
    return (g["dx"], g["din1"][0], g["din1"][1], g["dwqkv"], g["dbqkv"], g["dln"][0],
            g["dln"][1], g["dln"][2], g["dln"][3], g["din2"][0], g["din2"][1], g["dwout"],
            g["dbout"], *(None if a is None else b for a, b in zip(
                tables, (g["dbx"], g["dby"], g["dscale"][:, 0], g["dscale"][:, 1]))))


def mega_line_fwd(x: torch.Tensor, *params, heads: int):
    """K5's float32 forward (``bf_axial_block_mega_fwd``): ``(out,
    residuals)``; counts ``mega_line_fwd.launches``."""
    what = "mega_axial_block (bf_axial_block_mega_fwd)"
    d = _check_kernel_shapes(what, x, heads)
    bt, h, w, c = x.shape
    r, dev = bt * h * w, x.device
    p = _kernel_params(x, *params, heads, what)
    x = x.contiguous()
    stats1 = torch.empty(2, bt, c, device=dev)
    qkv = torch.empty(r, 3 * c, device=dev)
    ao = torch.empty(r, c, device=dev)  # scratch, as the TPU kernel's ao_s
    ao_r = torch.empty(r, c, device=dev)
    stats2 = torch.empty(2, bt, c, device=dev)
    out = torch.empty_like(x)
    lib = _build.library()
    err = lib.bf_axial_block_mega_fwd(
        d, x.data_ptr(), *(a.data_ptr() for a in p.values()), stats1.data_ptr(), qkv.data_ptr(),
        ao.data_ptr(), ao_r.data_ptr(), stats2.data_ptr(), out.data_ptr(), bt, h, w, c, heads,
        _build.stream_handle(dev))
    _build.check(lib, err, what)
    mega_line_fwd.launches += 1
    return out, (stats1, qkv, ao_r)


def mega_line_bwd(do: torch.Tensor, x: torch.Tensor, *params, heads: int, residuals) -> tuple:
    """K5's float32 backward (``bf_axial_block_mega_bwd``): the gradients of
    ``(x, *PARAM_NAMES)``; the weight, bias and InstanceNorm gradients
    float32 atomic sums (last bits vary from run to run), the table, scale
    and LN gradients the line kernels' fixed-order sums.  Counts
    ``mega_line_bwd.launches``."""
    what = "mega_axial_block_bwd (bf_axial_block_mega_bwd)"
    d = _check_kernel_shapes(what, x, heads)
    bt, h, w, c = x.shape
    r, dev = bt * h * w, x.device
    p = _kernel_params(x, *params, heads, what)
    _build.check_shapes(what, do=(do, x.shape))
    stats1, qkv, ao_r = _check_residuals(what, x, residuals)
    g = _grad_buffers(x, heads, zero=True)
    # Every tensor whose pointer the kernels get is held by a name until the
    # launches are queued.
    x, do = x.contiguous(), do.to(x.dtype).contiguous()
    wqkv_t, wout_t = p["wqkv"].t().contiguous(), p["wout"].t().contiguous()
    stats2 = torch.empty(2, bt, c, device=dev)
    work = torch.empty(r, c, device=dev)  # dy2, then dxn
    sums = torch.empty(2, bt, c, device=dev)
    dao = torch.empty(r, c, device=dev)
    dqkv = torch.empty(r, 3 * c, device=dev)
    dacc = torch.empty(r, 3 * c, device=dev)
    lstats = torch.empty(bt, heads, h * w, 3, device=dev) if max(h, w) > LINE_TILE else None
    part, plan = line_bwd_scratch(bt, h, w, heads, d, dev)
    lib = _build.library()
    err = lib.bf_axial_block_mega_bwd(
        d, x.data_ptr(), do.data_ptr(), qkv.data_ptr(), p["in1_w"].data_ptr(),
        p["in1_b"].data_ptr(), wqkv_t.data_ptr(), p["ln"].data_ptr(), p["in2_w"].data_ptr(),
        p["in2_b"].data_ptr(), wout_t.data_ptr(), p["bias_x"].data_ptr(), p["bias_y"].data_ptr(),
        p["scale"].data_ptr(), stats1.data_ptr(), ao_r.data_ptr(), stats2.data_ptr(),
        work.data_ptr(), sums.data_ptr(), dao.data_ptr(), dqkv.data_ptr(), dacc.data_ptr(),
        None if lstats is None else lstats.data_ptr(), part.data_ptr(), *plan,
        *(a.data_ptr() for a in g.values()), bt, h, w, c, heads, _build.stream_handle(dev))
    _build.check(lib, err, what)
    mega_line_bwd.launches += 1
    return _grads(g, params)


def mega_hopper_fwd(x: torch.Tensor, *params, heads: int):
    """K5's bf16 forward (``bf_mega_hopper_fwd``): K1's Hopper chain with the
    axial attention of ``csrc/lane_hopper.cuh`` in its middle; ``(out,
    residuals)``.  Counts ``mega_hopper_fwd.launches``."""
    what = "mega_axial_block (bf_mega_hopper_fwd)"
    d = _check_kernel_shapes(what, x, heads)
    bt, h, w, c = x.shape
    r, dev, dt = bt * h * w, x.device, x.dtype
    p = _kernel_params(x, *params, heads, what)
    x = x.contiguous()
    stats1 = torch.empty(2, bt, c, device=dev)
    qkv = torch.empty(r, 3 * c, device=dev, dtype=dt)
    ao = torch.empty(r, c, device=dev)  # float32 scratch, as the TPU kernel's ao_s
    ao_r = torch.empty(r, c, device=dev, dtype=dt)
    stats2 = torch.empty(2, bt, c, device=dev)
    xs = torch.empty(r, c, device=dev, dtype=dt)  # xn, then y2
    out = torch.empty_like(x)
    _build.check_tma(what, x=x, wqkv=p["wqkv"], wout=p["wout"], qkv=qkv, ao=ao, ao_r=ao_r,
                     xs=xs, out=out)
    lib = _build.library()
    err = lib.bf_mega_hopper_fwd(
        d, x.data_ptr(), *(a.data_ptr() for a in p.values()), stats1.data_ptr(), qkv.data_ptr(),
        ao.data_ptr(), ao_r.data_ptr(), stats2.data_ptr(), xs.data_ptr(), out.data_ptr(), bt, h,
        w, c, heads, _build.stream_handle(dev))
    _build.check(lib, err, what)
    mega_hopper_fwd.launches += 1
    return out, (stats1, qkv, ao_r)


def mega_hopper_bwd(do: torch.Tensor, x: torch.Tensor, *params, heads: int, residuals) -> tuple:
    """K5's bf16 backward (``bf_mega_hopper_bwd``): K1's Hopper backward chain
    with the axial attention's backward of ``csrc/lane_hopper.cuh`` in its
    middle; the weight gradients by split-K token ranges
    (:func:`~bubbleformer_tpu_torch.ops.hopper_gemm.split_k_plan`), the bias
    and InstanceNorm gradients by per-plane sums, the table, scale and LN
    gradients by per-block partials, each added in a fixed order, so every
    parameter gradient repeats bit for bit.  Counts
    ``mega_hopper_bwd.launches``."""
    what = "mega_axial_block_bwd (bf_mega_hopper_bwd)"
    d = _check_kernel_shapes(what, x, heads)
    bt, h, w, c = x.shape
    r, dev, dt = bt * h * w, x.device, x.dtype
    p = _kernel_params(x, *params, heads, what)
    _build.check_shapes(what, do=(do, x.shape))
    stats1, qkv, ao_r = _check_residuals(what, x, residuals)
    g = _grad_buffers(x, heads, zero=False)
    x, do = x.contiguous(), do.to(dt).contiguous()
    wqkv_t, wout_t = p["wqkv"].t().contiguous(), p["wout"].t().contiguous()
    stats2 = torch.empty(2, bt, c, device=dev)
    work = torch.empty(r, c, device=dev)  # dy2, then dxn
    sums = torch.empty(2, bt, 3 * c, device=dev)
    dao = torch.empty(r, c, device=dev, dtype=dt)
    dqkv = torch.empty(r, 3 * c, device=dev, dtype=dt)
    dacc = torch.empty(r, 3 * c, device=dev)
    xs = torch.empty(r, c, device=dev, dtype=dt)  # y2, then xn
    bounds_out, bounds_qkv = split_k_plan(r, c, c), split_k_plan(r, 3 * c, c)
    s_out, s_qkv = len(bounds_out) - 1, len(bounds_qkv) - 1
    part_w = torch.empty(max(s_out * c, s_qkv * 3 * c) * c, device=dev)
    _build.check_tma(what, x=x, do=do, qkv=qkv, ao=ao_r, wqkv_t=wqkv_t, wout_t=wout_t, dao=dao,
                     dqkv=dqkv, dacc=dacc, xs=xs, work=work, dx=g["dx"])
    lane_part, plan = lane_bwd_scratch(bt, h, w, heads, d, dev, MODE_MEGA)
    lib = _build.library()
    err = lib.bf_mega_hopper_bwd(
        d, x.data_ptr(), do.data_ptr(), qkv.data_ptr(), p["in1_w"].data_ptr(),
        p["in1_b"].data_ptr(), wqkv_t.data_ptr(), p["ln"].data_ptr(), p["in2_w"].data_ptr(),
        p["in2_b"].data_ptr(), wout_t.data_ptr(), p["bias_x"].data_ptr(), p["bias_y"].data_ptr(),
        p["scale"].data_ptr(), stats1.data_ptr(), ao_r.data_ptr(), stats2.data_ptr(),
        work.data_ptr(), sums.data_ptr(), dao.data_ptr(), dqkv.data_ptr(), dacc.data_ptr(),
        xs.data_ptr(), part_w.data_ptr(), _build.int32_array(bounds_out), s_out,
        _build.int32_array(bounds_qkv), s_qkv, lane_part.data_ptr(), *plan,
        *(a.data_ptr() for a in g.values()), bt, h, w, c, heads, _build.stream_handle(dev))
    _build.check(lib, err, what)
    mega_hopper_bwd.launches += 1
    return _grads(g, params)


mega_line_fwd.launches = mega_line_bwd.launches = 0
mega_hopper_fwd.launches = mega_hopper_bwd.launches = 0


def mega_kernels(dtype: torch.dtype) -> tuple:
    """K5's ``(forward, backward)`` kernels on the card for ``dtype``: the
    Hopper chain for bfloat16, the first chain for float32; any other dtype
    raises."""
    if dtype == torch.bfloat16:
        return mega_hopper_fwd, mega_hopper_bwd
    if dtype == torch.float32:
        return mega_line_fwd, mega_line_bwd
    raise TypeError(f"mega_axial_block kernel takes float32 or bfloat16, not {dtype}")


def mega_axial_block_fwd(x: torch.Tensor, *params, heads: int):
    """K5's forward kernels on CUDA tensors, :func:`mega_kernels` picks them
    by dtype: ``(out, residuals)`` where ``residuals = (stats1, qkv, ao)``
    are what the backward kernels read — the float32 IN1 statistics of ``x``
    ``(2, BT, C)`` (mean; rstd), the rounded raw QKV projection ``(BT*H*W,
    3C)`` and the rounded attention output ``(BT*H*W, C)``, both in
    ``x.dtype``.  Counts ``mega_axial_block.launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"mega_axial_block_fwd: the kernels need a CUDA tensor, not {x.device}")
    out = mega_kernels(x.dtype)[0](x, *params, heads=heads)
    mega_axial_block.launches += 1
    return out


def mega_axial_block_bwd(do: torch.Tensor, x: torch.Tensor, *params, heads: int,
                         residuals=None) -> tuple:
    """K5's backward: the gradients of ``(x, *PARAM_NAMES)``, as
    :func:`mega_axial_bwd_plain` returns them.

    CPU tensors take :func:`mega_axial_bwd_plain` (``residuals`` unused).
    CUDA tensors launch the kernels :func:`mega_kernels` picks by dtype on the
    ``residuals`` of :func:`mega_axial_block_fwd` and count
    ``mega_axial_block_bwd.launches``."""
    if x.device.type == "cpu":
        return mega_axial_bwd_plain(do, x, *params, heads=heads)
    if x.device.type != "cuda":
        raise ValueError(f"mega_axial_block_bwd: unsupported device {x.device}")
    grads = mega_kernels(x.dtype)[1](do, x, *params, heads=heads, residuals=residuals)
    mega_axial_block_bwd.launches += 1
    return grads


class _MegaAxial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, heads, x, *params):
        if x.device.type == "cpu":
            out, residuals = mega_axial_plain(x, *params, heads=heads), ()
        elif x.device.type == "cuda":
            out, residuals = mega_axial_block_fwd(x, *params, heads=heads)
        else:
            raise ValueError(f"mega_axial_block: unsupported device {x.device}")
        ctx.heads = heads
        ctx.absent = tuple(a is None for a in params)
        ctx.save_for_backward(x, *(a for a in params if a is not None), *residuals)
        return out

    @staticmethod
    def backward(ctx, do):
        saved = list(ctx.saved_tensors)
        x = saved.pop(0)
        params = [None if absent else saved.pop(0) for absent in ctx.absent]
        grads = mega_axial_block_bwd(do, x, *params, heads=ctx.heads,
                                     residuals=tuple(saved) or None)
        return (None, *(None if g is None else g.to(a.dtype)
                         for g, a in zip(grads, [x] + params)))


def mega_axial_block(
    x: torch.Tensor, in1_scale: torch.Tensor, in1_bias: torch.Tensor,
    wqkv: torch.Tensor, bqkv: torch.Tensor,
    qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    in2_scale: torch.Tensor, in2_bias: torch.Tensor,
    wout: torch.Tensor, bout: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int,
) -> torch.Tensor:
    """Whole axial branch; returns the branch output ``(BT, H, W, C)`` in
    ``x.dtype`` (the residual and the epilogue are the caller's),
    differentiable in every argument.

    ``x``: ``(BT, H, W, C)`` float32 or bfloat16.  ``wqkv`` ``(3C, C)`` and
    ``wout`` ``(C, C)`` are torch ``(out, in)`` weights, cast to ``x.dtype``
    for the products; every other parameter is used in float32.  ``bias_x``
    ``(heads, W, W)`` / ``bias_y`` ``(heads, H, H)``: the T5 tables;
    ``scale_x`` / ``scale_y`` ``(heads,)``: per-axis attn_scale.

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    (``mega_axial_block.launches`` and ``mega_axial_block_bwd.launches``
    count them).
    """
    return _MegaAxial.apply(heads, x, in1_scale, in1_bias, wqkv, bqkv, qn_scale, qn_bias,
                            kn_scale, kn_bias, in2_scale, in2_bias, wout, bout, bias_x, bias_y,
                            scale_x, scale_y)


mega_axial_block.launches = 0
mega_axial_block_bwd.launches = 0
