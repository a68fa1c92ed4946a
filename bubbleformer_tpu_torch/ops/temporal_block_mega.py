"""K1, the whole temporal-attention branch, and K3, its streamed core;
forward and backward.

K1 is the counterpart of ``bubbleformer_tpu/ops/temporal_block_mega.py:
mega_temporal_block``: InstanceNorm1 -> QKV projection (heads-major
``[q|k|v]``) -> per-head qk-LayerNorm -> softmax attention over T with the T5
bias and the ``s*P + (1-s)/T`` blend -> InstanceNorm2 -> output projection,
with LayerScale gamma folded into the output weights by the caller and the
residual added outside.

:func:`mega_temporal_block` is a ``torch.autograd.Function``.  On CUDA
tensors its forward runs the hand-written kernel ``csrc/temporal_block.cu``
(:func:`mega_temporal_block_fwd`) and its backward the one in
``csrc/temporal_block_bwd.cu`` (:func:`mega_temporal_block_bwd`); on CPU
tensors they take :func:`temporal_branch_plain` and
:func:`temporal_branch_bwd_plain`, and on any other device they raise.

Rounding follows the TPU kernel (``temporal_block_mega.py:246-266`` forward,
``:324-449`` backward): xn, qkv, q/k/v, y2 and out in the activation dtype;
the attention output ``ao`` and every statistic in float32.  In the backward
``dao``, ``s*dao`` and the raw-component ``dqkv`` are rounded to the
activation dtype (``:344``, ``:376``, ``:412-423``) and ``dx`` is returned in
it; every parameter gradient is float32.  Two differences from the TPU
kernel's residuals: that kernel keeps ``ao`` in the activation dtype
(``:259``, out_shape ``:853``) and recomputes IN2 from the rounded copy,
while the port keeps the float32 ``ao`` its forward already wrote, so its
backward differentiates exactly the function its forward computed; and that
kernel redoes IN1 and the QKV product in its backward, while the port's
forward also writes the rounded raw ``qkv`` (the same values) for its
backward to read.

K3, :func:`core_temporal_attention`, is the counterpart of
``core_temporal_attention`` of the same JAX module: the middle of K1 — QKV
projection, qk-LayerNorm, T x T attention — from the InstanceNorm1 output
``xn``, with InstanceNorm1, InstanceNorm2 and the output projection left to
the caller.  It rounds ``ao`` to the activation dtype and its backward
returns ``dxn = dtype(W^T dqkv)``.  Its kernels are K1's middle launches
with the InstanceNorm taken out (``bf_core_temporal_fwd`` in
``csrc/temporal_block.cu``, ``bf_core_temporal_bwd`` in
``csrc/temporal_block_bwd.cu``); the plain versions share K1's attention
arithmetic (:func:`_qkv_attention`, :func:`_attention_recompute`,
:func:`_attention_bwd`).  As for K1, the forward kernel writes the rounded
raw qkv where a backward can run and the backward kernel reads it, where
the TPU kernel recomputes the projection (the same values, one
2*R*C*3C-FLOP product less per call).

:func:`mega_temporal_supported` and :func:`core_temporal_supported` are the
JAX package's routing gates, copied.
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
from bubbleformer_tpu_torch.ops.attention import axis_attention

_EPS = 1e-5
HEAD_DIM = 64  # the kernels' compile-time head dim
MAX_T = 8

# Argument names after ``x``, in the order every function here takes them.
PARAM_NAMES = ("in1_scale", "in1_bias", "wqkv", "bqkv", "qn_scale", "qn_bias", "kn_scale",
               "kn_bias", "in2_scale", "in2_bias", "wout", "bout", "bias", "scale_factor")


def _plane_xhat(x: torch.Tensor):
    """``(xhat, rstd)`` of float32 ``(B, T, N, C)`` normalized over N with
    single-pass statistics, the TPU kernel's ``_in_fwd_t``."""
    mu = x.mean(dim=2, keepdim=True)
    var = torch.clamp((x * x).mean(dim=2, keepdim=True) - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + _EPS)
    return (x - mu) * rstd, rstd


def _plane_norm_bwd(dy, xhat, rstd, weight):
    """InstanceNorm over N backward in the kernel's form:
    ``dx = rstd * w * (dy - mean(dy) - xhat * mean(dy * xhat))``; returns
    ``(dx, dweight, dbias)`` in ``dy``'s dtype."""
    n = dy.shape[2]
    s0 = dy.sum(dim=2, keepdim=True)
    s1 = (dy * xhat).sum(dim=2, keepdim=True)
    dx = rstd * weight.to(dy.dtype) * (dy - s0 / n - xhat * (s1 / n))
    return dx, s1.sum(dim=(0, 1, 2)), s0.sum(dim=(0, 1, 2))


def _seq(a):  # (b, t, n, heads, d) -> (b, n, heads, t, d)
    return a.permute(0, 2, 3, 1, 4)


def _unseq(a):
    return a.permute(0, 3, 1, 2, 4)


def _qkv_attention(xn, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias, bias, scale_factor,
                   heads):
    """The middle of the branch, K3's function: the QKV projection of the
    rounded InstanceNorm1 output ``xn`` ``(b, t, n, c)`` (dtype values),
    qk-LayerNorm and the T x T attention; returns the blended attention
    output ``(b, t, n, c)`` in the accumulation dtype, unrounded."""
    b, t, n, c = xn.shape
    d = c // heads
    dt, acc = xn.dtype, accumulation_dtype(xn.dtype)
    # Products of dtype values accumulated in float32, as on the tensor cores.
    qkv = (torch.matmul(xn.to(acc), wqkv.to(dt).to(acc).t()) + bqkv.to(acc)).to(dt)
    qkv = qkv.reshape(b, t, n, heads, 3, d)
    q = layer_norm_f32(qkv[..., 0, :], qn_scale, qn_bias).to(dt)
    k = layer_norm_f32(qkv[..., 1, :], kn_scale, kn_bias).to(dt)
    v = qkv[..., 2, :]
    ao = axis_attention(_seq(q), _seq(k), _seq(v), bias, scale_factor)  # float32 (or float64)
    return _unseq(ao).reshape(b, t, n, c)


def temporal_branch_plain(
    x: torch.Tensor, in1_scale: torch.Tensor, in1_bias: torch.Tensor,
    wqkv: torch.Tensor, bqkv: torch.Tensor,
    qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    in2_scale: torch.Tensor, in2_bias: torch.Tensor,
    wout: torch.Tensor, bout: torch.Tensor,
    bias: Optional[torch.Tensor] = None, scale_factor: Optional[torch.Tensor] = None,
    *, heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of K1's forward; the arguments of
    :func:`mega_temporal_block`."""
    b, t, h, w, c = x.shape
    dt, acc = x.dtype, accumulation_dtype(x.dtype)
    xhat1, _ = _plane_xhat(x.to(acc).reshape(b, t, h * w, c))
    xn = (xhat1 * in1_scale.to(acc) + in1_bias.to(acc)).to(dt)
    ao = _qkv_attention(xn, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias, bias,
                        scale_factor, heads)
    xhat2, _ = _plane_xhat(ao)
    y2 = (xhat2 * in2_scale.to(acc) + in2_bias.to(acc)).to(dt)
    out = torch.matmul(y2.to(acc), wout.to(dt).to(acc).t()) + bout.to(acc)
    return out.to(dt).reshape(b, t, h, w, c)


def _attention_recompute(xn, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias, bias,
                         scale_factor, heads, dt):
    """The forward of :func:`_qkv_attention` at its rounding points, keeping
    what the backward needs.  ``xn``: ``(b, t, n, c)`` in the accumulation
    dtype, holding dtype values."""
    b, t, n, c = xn.shape
    d, dev, acc = c // heads, xn.device, xn.dtype
    r = dict(w1=wqkv.to(dt).to(acc), sh=(
        torch.ones(heads, device=dev, dtype=acc) if scale_factor is None
        else scale_factor.to(acc)).reshape(heads, 1, 1))
    bias_t = torch.zeros(heads, t, t, device=dev, dtype=acc) if bias is None else bias.to(acc)
    qkv = (xn @ r["w1"].t() + bqkv.to(acc)).to(dt).to(acc).reshape(b, t, n, heads, 3, d)
    r["qhat"], r["qrstd"] = row_xhat(qkv[..., 0, :])
    r["khat"], r["krstd"] = row_xhat(qkv[..., 1, :])
    q = (r["qhat"] * qn_scale.to(acc) + qn_bias.to(acc)).to(dt).to(acc)
    k = (r["khat"] * kn_scale.to(acc) + kn_bias.to(acc)).to(dt).to(acc)
    r["qs"], r["ks"], r["vs"] = _seq(q), _seq(k), _seq(qkv[..., 2, :])
    logits = r["qs"] @ r["ks"].transpose(-1, -2) * d**-0.5 + bias_t
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    r["p"] = e * (1.0 / e.sum(dim=-1, keepdim=True))
    ao = r["sh"] * (r["p"] @ r["vs"]) + (1.0 - r["sh"]) * r["vs"].mean(dim=-2, keepdim=True)
    r["ao"] = _unseq(ao).reshape(b, t, n, c)
    return r


def _attention_bwd(r, dao, xn, qn_scale, kn_scale, heads, dt):
    """Backward of :func:`_qkv_attention` from the gradient ``dao`` of its
    output ``(b, t, n, c)`` (accumulation dtype, holding dtype values) and
    the recompute ``r``.  The TPU kernels' per-row algebra
    (``temporal_block_mega.py:354-388``, ``:519-550``): with
    ``w_ij = dao_i . v_j``, ``dp = s*w``, ``dscale = sum (p - 1/T) * w``,
    ``dl = p * (dp - sum_j p dp)`` (the T5 table's gradient),
    ``dq = dl k / sqrt(d)``, ``dk = dl^T q / sqrt(d)`` and
    ``dv = p^T dtype(s*dao) + (1-s)/T * sum_i dao_i``; then the qk-LN
    backward, the raw-component ``dqkv`` rounded to ``dt``, and the
    projection's gradients.  Returns ``(dxn, dwqkv, dbqkv, dqn_scale,
    dqn_bias, dkn_scale, dkn_bias, dbias, dscale)``, ``dxn`` unrounded."""
    b, t, n, c = xn.shape
    acc = xn.dtype
    sh, p = r["sh"], r["p"]
    daos = _seq(dao.reshape(b, t, n, heads, c // heads))
    scaling = (c // heads) ** -0.5
    wmat = daos @ r["vs"].transpose(-1, -2)  # w_ij = dao_i . v_j
    dscale = ((p - 1.0 / t) * wmat).sum(dim=(0, 1, 3, 4))
    dp = sh * wmat
    dl = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dbias = dl.sum(dim=(0, 1))
    dq = (dl @ r["ks"]) * scaling
    dk = (dl.transpose(-1, -2) @ r["qs"]) * scaling
    sdao = (sh * daos).to(dt).to(acc)
    dv = p.transpose(-1, -2) @ sdao + ((1.0 - sh) / t * daos).sum(dim=-2, keepdim=True)
    dqr, dqn_scale, dqn_bias = layer_norm_bwd(_unseq(dq), r["qhat"], r["qrstd"], qn_scale)
    dkr, dkn_scale, dkn_bias = layer_norm_bwd(_unseq(dk), r["khat"], r["krstd"], kn_scale)
    dqkv = torch.stack([dqr.to(dt), dkr.to(dt), _unseq(dv).to(dt)], dim=-2).to(acc)
    dqkv = dqkv.reshape(b, t, n, 3 * c)
    dwqkv = dqkv.reshape(-1, 3 * c).t() @ xn.reshape(-1, c)
    dbqkv = dqkv.sum(dim=(0, 1, 2))
    return (dqkv @ r["w1"], dwqkv, dbqkv, dqn_scale, dqn_bias, dkn_scale, dkn_bias, dbias,
            dscale)


def temporal_branch_bwd_plain(
    do: torch.Tensor, x: torch.Tensor, in1_scale: torch.Tensor, in1_bias: torch.Tensor,
    wqkv: torch.Tensor, bqkv: torch.Tensor,
    qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    in2_scale: torch.Tensor, in2_bias: torch.Tensor,
    wout: torch.Tensor, bout: torch.Tensor,
    bias: Optional[torch.Tensor] = None, scale_factor: Optional[torch.Tensor] = None,
    *, heads: int,
) -> tuple:
    """Plain PyTorch version of K1's backward: explicit formulas, no autograd.

    Recomputes the forward from ``x`` and returns the gradients of
    ``(x, *PARAM_NAMES)`` for the output gradient ``do``: ``dx`` in
    ``x.dtype``, the rest float32 (None for an absent ``bias`` or
    ``scale_factor``).  The attention part is :func:`_attention_bwd`, which
    K3's plain backward shares; ``dao`` is the InstanceNorm2 backward of
    ``do . W_out``, rounded to the activation dtype.
    """
    b, t, hh, ww, c = x.shape
    n, dt, acc = hh * ww, x.dtype, accumulation_dtype(x.dtype)

    # ---- recompute the forward at its rounding points
    xhat1, rstd1 = _plane_xhat(x.to(acc).reshape(b, t, n, c))
    xn = (xhat1 * in1_scale.to(acc) + in1_bias.to(acc)).to(dt).to(acc)
    r = _attention_recompute(xn, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias, bias,
                             scale_factor, heads, dt)
    xhat2, rstd2 = _plane_xhat(r["ao"])
    y2 = (xhat2 * in2_scale.to(acc) + in2_bias.to(acc)).to(dt).to(acc)

    # ---- output projection and InstanceNorm2
    dof = do.to(acc).reshape(b, t, n, c)
    dwout = dof.reshape(-1, c).t() @ y2.reshape(-1, c)
    dbout = dof.sum(dim=(0, 1, 2))
    dy2 = dof @ wout.to(dt).to(acc)
    dao, din2_scale, din2_bias = _plane_norm_bwd(dy2, xhat2, rstd2, in2_scale)

    # ---- attention, qk-LayerNorm, QKV projection, then InstanceNorm1
    dxn, dwqkv, dbqkv, dqn_scale, dqn_bias, dkn_scale, dkn_bias, dbias, dscale = _attention_bwd(
        r, dao.to(dt).to(acc), xn, qn_scale, kn_scale, heads, dt)
    dx, din1_scale, din1_bias = _plane_norm_bwd(dxn, xhat1, rstd1, in1_scale)
    return (dx.to(dt).reshape(x.shape), din1_scale, din1_bias, dwqkv, dbqkv,
            dqn_scale, dqn_bias, dkn_scale, dkn_bias, din2_scale, din2_bias, dwout, dbout,
            None if bias is None else dbias, None if scale_factor is None else dscale)


def _check_kernel_shapes(what, x, heads):
    b, t, h, w, c = x.shape
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, not {x.dtype}")
    if c != heads * HEAD_DIM or t > MAX_T or (h * w) % 16 or c % 32:
        raise ValueError(
            f"{what} kernel needs head_dim {HEAD_DIM}, T <= {MAX_T}, H*W % 16 == 0 and "
            f"C % 32 == 0; got T={t}, H*W={h * w}, C={c}, heads={heads}"
        )


def _f32(a, dev):
    return a.detach().to(device=dev, dtype=torch.float32).contiguous()


def _core_params(xn, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias, bias, scale_factor,
                 heads, what):
    """The parameters of K3, and K1's shared with it, as the C entries take
    them: float32 vectors, W_qkv in the activation dtype, the four qk-LN
    vectors stacked, absent bias/scale filled in."""
    b, t, h, w, c = xn.shape
    dev = xn.device
    p = dict(
        wqkv=wqkv.detach().to(device=dev, dtype=xn.dtype).contiguous(), bqkv=_f32(bqkv, dev),
        ln=torch.stack([_f32(a, dev) for a in (qn_scale, qn_bias, kn_scale, kn_bias)]),
        bias=torch.zeros(heads, t, t, device=dev) if bias is None else _f32(bias, dev),
        scale=torch.ones(heads, device=dev) if scale_factor is None else _f32(scale_factor, dev),
    )
    _build.check_shapes(what, wqkv=(p["wqkv"], (3 * c, c)), bqkv=(p["bqkv"], (3 * c,)),
                        ln=(p["ln"], (4, HEAD_DIM)), bias=(p["bias"], (heads, t, t)),
                        scale_factor=(p["scale"], (heads,)))
    return p


def _kernel_params(x, in1_scale, in1_bias, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias,
                   in2_scale, in2_bias, wout, bout, bias, scale_factor, heads):
    """K1's parameters as its C entries take them, in their order: those of
    :func:`_core_params`, the InstanceNorm vectors and the output projection
    (W_out in the activation dtype)."""
    c, dev = x.shape[-1], x.device
    core = _core_params(x, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias, bias,
                        scale_factor, heads, "mega_temporal_block")
    p = dict(
        in1_w=_f32(in1_scale, dev), in1_b=_f32(in1_bias, dev), wqkv=core["wqkv"],
        bqkv=core["bqkv"], ln=core["ln"], in2_w=_f32(in2_scale, dev), in2_b=_f32(in2_bias, dev),
        wout=wout.detach().to(device=dev, dtype=x.dtype).contiguous(), bout=_f32(bout, dev),
        bias=core["bias"], scale=core["scale"],
    )
    _build.check_shapes(
        "mega_temporal_block", in1_scale=(p["in1_w"], (c,)), in1_bias=(p["in1_b"], (c,)),
        in2_scale=(p["in2_w"], (c,)), in2_bias=(p["in2_b"], (c,)), wout=(p["wout"], (c, c)),
        bout=(p["bout"], (c,)),
    )
    return p


def mega_temporal_block_fwd(x: torch.Tensor, *params, heads: int):
    """K1's forward kernel on CUDA tensors: ``(out, residuals)`` where
    ``residuals = (stats1, qkv, ao, stats2)`` are what the backward kernel
    reads — the float32 IN1 statistics of ``x`` ``(2, B*T, C)`` (mean; rstd),
    the rounded raw QKV projection ``(B*T*N, 3C)`` in ``x.dtype``, the
    float32 attention output ``(B*T*N, C)`` and its IN2 statistics.  Counts
    ``mega_temporal_block.launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"mega_temporal_block_fwd: the kernel needs a CUDA tensor, not {x.device}")
    _check_kernel_shapes("mega_temporal_block", x, heads)
    b, t, h, w, c = x.shape
    n, dev, dt = h * w, x.device, x.dtype
    p = _kernel_params(x, *params, heads)
    x = x.contiguous()
    stats1 = torch.empty(2, b * t, c, device=dev)
    qkv = torch.empty(b * t * n, 3 * c, device=dev, dtype=dt)
    ao = torch.empty(b * t * n, c, device=dev)
    stats2 = torch.empty(2, b * t, c, device=dev)
    out = torch.empty_like(x)
    lib = _build.library()
    err = lib.bf_temporal_block_fwd(
        _build.DTYPE_CODES[dt], x.data_ptr(), *(a.data_ptr() for a in p.values()),
        stats1.data_ptr(), qkv.data_ptr(), ao.data_ptr(), stats2.data_ptr(), out.data_ptr(),
        b, t, n, c, heads, _build.stream_handle(dev),
    )
    _build.check(lib, err, "bf_temporal_block_fwd")
    mega_temporal_block.launches += 1
    return out, (stats1, qkv, ao, stats2)


def mega_temporal_block_bwd(do: torch.Tensor, x: torch.Tensor, *params, heads: int,
                            residuals=None) -> tuple:
    """K1's backward: the gradients of ``(x, *PARAM_NAMES)``, as
    :func:`temporal_branch_bwd_plain` returns them.

    CPU tensors take :func:`temporal_branch_bwd_plain` (``residuals``
    unused).  CUDA tensors launch ``csrc/temporal_block_bwd.cu`` on the
    ``residuals`` of :func:`mega_temporal_block_fwd` and count
    ``mega_temporal_block_bwd.launches``.  The parameter gradients are sums
    over all B*T*N tokens, accumulated with float32 atomics: their last bits
    vary from run to run."""
    if x.device.type == "cpu":
        return temporal_branch_bwd_plain(do, x, *params, heads=heads)
    if x.device.type != "cuda":
        raise ValueError(f"mega_temporal_block_bwd: unsupported device {x.device}")
    if residuals is None:
        raise ValueError("mega_temporal_block_bwd on CUDA needs the forward kernel's residuals")
    _check_kernel_shapes("mega_temporal_block_bwd", x, heads)
    b, t, h, w, c = x.shape
    n, g, dev, dt = h * w, b * t, x.device, x.dtype
    p = _kernel_params(x, *params, heads)
    stats1, qkv, ao, stats2 = residuals
    _build.check_shapes("mega_temporal_block_bwd", do=(do, x.shape), qkv=(qkv, (g * n, 3 * c)),
                        ao=(ao, (g * n, c)), stats1=(stats1, (2, g, c)),
                        stats2=(stats2, (2, g, c)))
    if qkv.dtype != dt:
        raise TypeError(f"mega_temporal_block_bwd: qkv residual is {qkv.dtype}, x is {dt}")

    def zeros(*shape):
        return torch.zeros(*shape, device=dev)

    grads = dict(
        dx=torch.empty(x.shape, device=dev, dtype=dt), din1=zeros(2, c),
        dwqkv=zeros(3 * c, c), dbqkv=zeros(3 * c), dln=zeros(4, HEAD_DIM), din2=zeros(2, c),
        dwout=zeros(c, c), dbout=zeros(c), dbias=zeros(heads, t, t), dscale=zeros(heads),
    )
    # Every tensor whose pointer the kernels get is held by a name until the
    # launches are queued: a temporary freed earlier could be handed to the
    # next allocation before the kernels read it.
    x, do = x.contiguous(), do.to(dt).contiguous()
    wqkv_t, wout_t = p["wqkv"].t().contiguous(), p["wout"].t().contiguous()
    work = torch.empty(g * n, c, device=dev)  # dy2, then dxn
    sums = torch.empty(2, g, c, device=dev)
    dqkv = torch.empty(g * n, 3 * c, device=dev, dtype=dt)
    lib = _build.library()
    err = lib.bf_temporal_block_bwd(
        _build.DTYPE_CODES[dt], x.data_ptr(), do.data_ptr(), qkv.data_ptr(),
        p["in1_w"].data_ptr(), p["in1_b"].data_ptr(), wqkv_t.data_ptr(), p["ln"].data_ptr(),
        p["in2_w"].data_ptr(), p["in2_b"].data_ptr(), wout_t.data_ptr(),
        p["bias"].data_ptr(), p["scale"].data_ptr(),
        stats1.data_ptr(), ao.data_ptr(), stats2.data_ptr(),
        work.data_ptr(), sums.data_ptr(), dqkv.data_ptr(),
        *(a.data_ptr() for a in grads.values()),
        b, t, n, c, heads, _build.stream_handle(dev),
    )
    _build.check(lib, err, "bf_temporal_block_bwd")
    mega_temporal_block_bwd.launches += 1
    gr = grads
    bias, scale_factor = params[-2], params[-1]
    return (gr["dx"], gr["din1"][0], gr["din1"][1], gr["dwqkv"], gr["dbqkv"],
            gr["dln"][0], gr["dln"][1], gr["dln"][2], gr["dln"][3], gr["din2"][0], gr["din2"][1],
            gr["dwout"], gr["dbout"], None if bias is None else gr["dbias"],
            None if scale_factor is None else gr["dscale"])


class _TemporalBranch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, heads, x, *params):
        if x.device.type == "cpu":
            out, residuals = temporal_branch_plain(x, *params, heads=heads), ()
        elif x.device.type == "cuda":
            out, residuals = mega_temporal_block_fwd(x, *params, heads=heads)
        else:
            raise ValueError(f"mega_temporal_block: unsupported device {x.device}")
        ctx.heads = heads
        ctx.absent = tuple(a is None for a in params)
        ctx.save_for_backward(x, *(a for a in params if a is not None), *residuals)
        return out

    @staticmethod
    def backward(ctx, do):
        saved = list(ctx.saved_tensors)
        x = saved.pop(0)
        params = [None if absent else saved.pop(0) for absent in ctx.absent]
        grads = mega_temporal_block_bwd(do, x, *params, heads=ctx.heads,
                                        residuals=tuple(saved) or None)
        grads = [None if g is None else g.to(a.dtype)
                 for g, a in zip(grads, [x] + params)]
        return (None, *grads)


def mega_temporal_block(
    x: torch.Tensor, in1_scale: torch.Tensor, in1_bias: torch.Tensor,
    wqkv: torch.Tensor, bqkv: torch.Tensor,
    qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    in2_scale: torch.Tensor, in2_bias: torch.Tensor,
    wout: torch.Tensor, bout: torch.Tensor,
    bias: Optional[torch.Tensor] = None, scale_factor: Optional[torch.Tensor] = None,
    *, heads: int,
) -> torch.Tensor:
    """Whole temporal branch; returns the branch output ``(B, T, H, W, C)``
    in ``x.dtype`` (the residual is the caller's), differentiable in every
    argument.

    ``x``: ``(B, T, H, W, C)`` float32 or bfloat16.  ``wqkv`` ``(3C, C)`` and
    ``wout`` ``(C, C)`` are torch ``(out, in)`` weights (``wout``/``bout``
    already scaled by LayerScale gamma), cast to ``x.dtype`` for the
    products; every other parameter is used in float32.  ``bias``: the T5
    table ``(heads, T, T)``; ``scale_factor``: attn_scale ``(heads,)``.

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    (``mega_temporal_block.launches`` and ``mega_temporal_block_bwd.launches``
    count them).
    """
    return _TemporalBranch.apply(heads, x, in1_scale, in1_bias, wqkv, bqkv, qn_scale, qn_bias,
                                 kn_scale, kn_bias, in2_scale, in2_bias, wout, bout, bias,
                                 scale_factor)


mega_temporal_block.launches = 0
mega_temporal_block_bwd.launches = 0


# ---------------------------------------------------------------------------
# K3: the streamed temporal core.

# Argument names after ``xn`` of the K3 functions, in their order.
CORE_PARAM_NAMES = ("wqkv", "bqkv", "qn_scale", "qn_bias", "kn_scale", "kn_bias", "bias",
                    "scale_factor")


def mega_temporal_supported(t_len: int, h: int, w: int, c: int) -> bool:
    """The JAX package's gate for the whole-branch megakernel
    (``bubbleformer_tpu/ops/temporal_block_mega.py:mega_temporal_supported``),
    copied: tokens a multiple of 128 and ``58*C*T*N`` bytes within its VMEM
    budget.  Plain arithmetic on the shape; it says which function the TPU
    package computes, not what this card can hold."""
    n = h * w
    if n % 128 != 0:
        return False
    return 58 * c * t_len * n <= int(118e6)


def core_temporal_supported(t_len: int, h: int, w: int, c: int) -> bool:
    """The JAX package's gate for the streamed core
    (``temporal_block_mega.py:core_temporal_supported``), copied: tokens a
    multiple of 128, C a multiple of 8, and a 128-token chunk within
    budget."""
    n = h * w
    if n % 128 or c % 8:
        return False
    return 50 * c * t_len * 128 <= int(100e6)


def core_temporal_plain(
    xn: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
    qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias: Optional[torch.Tensor] = None, scale_factor: Optional[torch.Tensor] = None,
    *, heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of K3's forward; the arguments of
    :func:`core_temporal_attention`.  It rounds where ``_core_fwd_kernel``
    (``temporal_block_mega.py:452-473``) rounds: qkv = dtype(f32 acc + b),
    q and k after qk-LN, and ``ao``; the softmax and the blend in float32."""
    b, t, h, w, c = xn.shape
    ao = _qkv_attention(xn.reshape(b, t, h * w, c), wqkv, bqkv, qn_scale, qn_bias, kn_scale,
                        kn_bias, bias, scale_factor, heads)
    return ao.to(xn.dtype).reshape(xn.shape)


def core_temporal_bwd_plain(
    dao: torch.Tensor, xn: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
    qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias: Optional[torch.Tensor] = None, scale_factor: Optional[torch.Tensor] = None,
    *, heads: int,
) -> tuple:
    """Plain PyTorch version of K3's backward (``_core_bwd_kernel :476-595``,
    ``fused_bwd :696-705``): explicit formulas, no autograd.

    Returns the gradients of ``(xn, *CORE_PARAM_NAMES)`` for the output
    gradient ``dao``: ``dxn = dtype(W^T dqkv)`` in ``xn.dtype``, the rest
    float32 (None for an absent ``bias`` or ``scale_factor``).  Rounding
    points: ``s*dao`` and the raw ``dqkv`` in the activation dtype."""
    b, t, h, w, c = xn.shape
    dt, acc = xn.dtype, accumulation_dtype(xn.dtype)
    xf = xn.to(acc).reshape(b, t, h * w, c)
    r = _attention_recompute(xf, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias, bias,
                             scale_factor, heads, dt)
    dxn, *grads = _attention_bwd(r, dao.to(dt).to(acc).reshape(xf.shape), xf, qn_scale,
                                 kn_scale, heads, dt)
    return (dxn.to(dt).reshape(xn.shape), *grads[:-2], None if bias is None else grads[-2],
            None if scale_factor is None else grads[-1])


def core_temporal_attention_fwd(xn: torch.Tensor, *params, heads: int, keep_qkv: bool = True):
    """K3's forward kernel on CUDA tensors (``csrc/temporal_block.cu``,
    ``bf_core_temporal_fwd``): ``(ao, qkv)``, ``ao`` in ``xn.dtype`` and,
    when ``keep_qkv``, the rounded raw QKV projection ``(B*T*N, 3C)`` in
    ``xn.dtype`` that the backward kernel reads (else None: no backward will
    run).  Counts ``core_temporal_attention.launches``."""
    if xn.device.type != "cuda":
        raise ValueError(
            f"core_temporal_attention_fwd: the kernel needs a CUDA tensor, not {xn.device}")
    _check_kernel_shapes("core_temporal_attention", xn, heads)
    p = _core_params(xn, *params, heads, "core_temporal_attention")
    b, t, h, w, c = xn.shape
    dev, dt = xn.device, xn.dtype
    xn = xn.contiguous()
    qkv = torch.empty(b * t * h * w, 3 * c, device=dev, dtype=dt) if keep_qkv else None
    ao = torch.empty_like(xn)
    lib = _build.library()
    err = lib.bf_core_temporal_fwd(
        _build.DTYPE_CODES[dt], xn.data_ptr(), *(a.data_ptr() for a in p.values()),
        None if qkv is None else qkv.data_ptr(), ao.data_ptr(), b, t, h * w, c, heads,
        _build.stream_handle(dev),
    )
    _build.check(lib, err, "bf_core_temporal_fwd")
    core_temporal_attention.launches += 1
    return ao, qkv


def core_temporal_attention_bwd(dao: torch.Tensor, xn: torch.Tensor, *params, heads: int,
                      qkv: Optional[torch.Tensor] = None) -> tuple:
    """K3's backward: the gradients :func:`core_temporal_bwd_plain` returns.

    CPU tensors take :func:`core_temporal_bwd_plain` (``qkv`` unused).  CUDA
    tensors launch ``csrc/temporal_block_bwd.cu``'s ``bf_core_temporal_bwd``
    on the forward kernel's ``qkv`` and count
    ``core_temporal_attention_bwd.launches``.  The parameter gradients are
    float32 atomic sums over all B*T*N tokens: their last bits vary from run
    to run."""
    if xn.device.type == "cpu":
        return core_temporal_bwd_plain(dao, xn, *params, heads=heads)
    if xn.device.type != "cuda":
        raise ValueError(f"core_temporal_attention_bwd: unsupported device {xn.device}")
    if qkv is None:
        raise ValueError("core_temporal_attention_bwd on CUDA needs the forward kernel's qkv")
    _check_kernel_shapes("core_temporal_attention_bwd", xn, heads)
    p = _core_params(xn, *params, heads, "core_temporal_attention_bwd")
    b, t, h, w, c = xn.shape
    g, dev, dt = b * t * h * w, xn.device, xn.dtype
    _build.check_shapes("core_temporal_attention_bwd", dao=(dao, xn.shape),
                        qkv=(qkv, (g, 3 * c)))
    if qkv.dtype != dt:
        raise TypeError(f"core_temporal_attention_bwd: qkv is {qkv.dtype}, xn is {dt}")

    def zeros(*shape):
        return torch.zeros(*shape, device=dev)

    grads = dict(dx=torch.empty(xn.shape, device=dev, dtype=dt), dwqkv=zeros(3 * c, c),
                 dbqkv=zeros(3 * c), dln=zeros(4, HEAD_DIM), dbias=zeros(heads, t, t),
                 dscale=zeros(heads))
    # Held by a name until the launches are queued (see mega_temporal_block_bwd).
    xn, dao = xn.contiguous(), dao.to(dt).contiguous()
    wqkv_t = p["wqkv"].t().contiguous()
    dqkv = torch.empty(g, 3 * c, device=dev, dtype=dt)
    lib = _build.library()
    err = lib.bf_core_temporal_bwd(
        _build.DTYPE_CODES[dt], xn.data_ptr(), dao.data_ptr(), qkv.data_ptr(),
        wqkv_t.data_ptr(), p["ln"].data_ptr(), p["bias"].data_ptr(), p["scale"].data_ptr(),
        dqkv.data_ptr(), *(a.data_ptr() for a in grads.values()), b, t, h * w, c, heads,
        _build.stream_handle(dev),
    )
    _build.check(lib, err, "bf_core_temporal_bwd")
    core_temporal_attention_bwd.launches += 1
    gr = grads
    bias, scale_factor = params[-2], params[-1]
    return (gr["dx"], gr["dwqkv"], gr["dbqkv"], gr["dln"][0], gr["dln"][1], gr["dln"][2],
            gr["dln"][3], None if bias is None else gr["dbias"],
            None if scale_factor is None else gr["dscale"])


class _CoreTemporal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, heads, keep_qkv, xn, *params):
        if xn.device.type == "cpu":
            ao, qkv = core_temporal_plain(xn, *params, heads=heads), None
        elif xn.device.type == "cuda":
            ao, qkv = core_temporal_attention_fwd(xn, *params, heads=heads, keep_qkv=keep_qkv)
        else:
            raise ValueError(f"core_temporal_attention: unsupported device {xn.device}")
        ctx.heads = heads
        ctx.absent = tuple(a is None for a in params)
        ctx.save_for_backward(xn, *(a for a in params if a is not None),
                              *(() if qkv is None else (qkv,)))
        return ao

    @staticmethod
    def backward(ctx, dao):
        saved = list(ctx.saved_tensors)
        xn = saved.pop(0)
        params = [None if absent else saved.pop(0) for absent in ctx.absent]
        grads = core_temporal_attention_bwd(dao, xn, *params, heads=ctx.heads,
                                  qkv=saved[0] if saved else None)
        return (None, None, *(None if g is None else g.to(a.dtype)
                              for g, a in zip(grads, [xn] + params)))


def core_temporal_attention(
    xn: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
    qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias: Optional[torch.Tensor] = None, scale_factor: Optional[torch.Tensor] = None,
    *, heads: int,
) -> torch.Tensor:
    """K3: QKV projection + qk-LayerNorm + T x T attention of the
    InstanceNorm1 output ``xn`` ``(B, T, H, W, C)`` (float32 or bfloat16);
    returns the blended attention output ``ao`` of the same shape and dtype,
    differentiable in every argument.  InstanceNorm1, InstanceNorm2 and the
    output projection are the caller's, as on the TPU
    (``bubbleformer_tpu/ops/temporal_block_mega.py:core_temporal_attention``).

    ``wqkv``: torch ``(3C, C)`` weight, cast to ``xn.dtype`` for the
    product; the other parameters are used in float32.  CPU tensors take the
    plain versions; CUDA tensors launch the kernels
    (``core_temporal_attention.launches`` and
    ``core_temporal_attention_bwd.launches`` count them).
    """
    args = (xn, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias, bias, scale_factor)
    # The forward kernel writes the raw qkv for the backward only where one
    # can run: not in a rollout under no_grad.
    keep_qkv = torch.is_grad_enabled() and any(
        a is not None and a.requires_grad for a in args)
    return _CoreTemporal.apply(heads, keep_qkv, *args)


core_temporal_attention.launches = 0
core_temporal_attention_bwd.launches = 0
