"""K1: the whole temporal-attention branch, forward and backward.

Counterpart of ``bubbleformer_tpu/ops/temporal_block_mega.py:
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
    d = c // heads
    dt, acc = x.dtype, accumulation_dtype(x.dtype)
    xhat1, _ = _plane_xhat(x.to(acc).reshape(b, t, h * w, c))
    xn = (xhat1 * in1_scale.to(acc) + in1_bias.to(acc)).to(dt)
    # Products of dtype values accumulated in float32, as on the tensor cores.
    qkv = (torch.matmul(xn.to(acc), wqkv.to(dt).to(acc).t()) + bqkv.to(acc)).to(dt)
    qkv = qkv.reshape(b, t, h, w, heads, 3, d)
    q = layer_norm_f32(qkv[..., 0, :], qn_scale, qn_bias).to(dt)
    k = layer_norm_f32(qkv[..., 1, :], kn_scale, kn_bias).to(dt)
    v = qkv[..., 2, :]

    def seq(a):  # (b, t, h, w, heads, d) -> (b, h, w, heads, t, d)
        return a.permute(0, 2, 3, 4, 1, 5)

    ao = axis_attention(seq(q), seq(k), seq(v), bias, scale_factor)  # float32 (or float64)
    ao = ao.permute(0, 4, 1, 2, 3, 5).reshape(b, t, h * w, c)
    xhat2, _ = _plane_xhat(ao)
    y2 = (xhat2 * in2_scale.to(acc) + in2_bias.to(acc)).to(dt)
    out = torch.matmul(y2.to(acc), wout.to(dt).to(acc).t()) + bout.to(acc)
    return out.to(dt).reshape(b, t, h, w, c)


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
    ``scale_factor``).  The attention backward is the TPU kernel's per-row
    algebra (``temporal_block_mega.py:354-388``): with ``w_ij = dao_i . v_j``,
    ``dp = s*w``, ``dscale = sum (p - 1/T) * w``, ``dl = p * (dp - sum_j p dp)``
    (the T5 table's gradient), ``dq = dl k / sqrt(d)``, ``dk = dl^T q / sqrt(d)``
    and ``dv = p^T dtype(s*dao) + (1-s)/T * sum_i dao_i``.
    """
    b, t, hh, ww, c = x.shape
    n, d, dt = hh * ww, c // heads, x.dtype
    dev, acc = x.device, accumulation_dtype(x.dtype)
    bias_t = torch.zeros(heads, t, t, device=dev, dtype=acc) if bias is None else bias.to(acc)
    s = torch.ones(heads, device=dev, dtype=acc) if scale_factor is None else scale_factor.to(acc)
    scaling = d**-0.5

    # ---- recompute the forward at its rounding points
    xhat1, rstd1 = _plane_xhat(x.to(acc).reshape(b, t, n, c))
    xn = (xhat1 * in1_scale.to(acc) + in1_bias.to(acc)).to(dt).to(acc)
    w1 = wqkv.to(dt).to(acc)
    qkv = (xn @ w1.t() + bqkv.to(acc)).to(dt).to(acc).reshape(b, t, n, heads, 3, d)
    qhat, qrstd = row_xhat(qkv[..., 0, :])
    khat, krstd = row_xhat(qkv[..., 1, :])
    q = (qhat * qn_scale.to(acc) + qn_bias.to(acc)).to(dt).to(acc)
    k = (khat * kn_scale.to(acc) + kn_bias.to(acc)).to(dt).to(acc)

    def seq(a):  # (b, t, n, heads, d) -> (b, n, heads, t, d)
        return a.permute(0, 2, 3, 1, 4)

    def unseq(a):
        return a.permute(0, 3, 1, 2, 4)

    qs, ks, vs = seq(q), seq(k), seq(qkv[..., 2, :])
    logits = qs @ ks.transpose(-1, -2) * scaling + bias_t
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    sh = s.reshape(heads, 1, 1)
    ao = sh * (p @ vs) + (1.0 - sh) * vs.mean(dim=-2, keepdim=True)
    xhat2, rstd2 = _plane_xhat(unseq(ao).reshape(b, t, n, c))
    y2 = (xhat2 * in2_scale.to(acc) + in2_bias.to(acc)).to(dt).to(acc)

    # ---- output projection and InstanceNorm2
    dof = do.to(acc).reshape(b, t, n, c)
    dwout = dof.reshape(-1, c).t() @ y2.reshape(-1, c)
    dbout = dof.sum(dim=(0, 1, 2))
    dy2 = dof @ wout.to(dt).to(acc)
    dao, din2_scale, din2_bias = _plane_norm_bwd(dy2, xhat2, rstd2, in2_scale)
    daos = seq(dao.to(dt).to(acc).reshape(b, t, n, heads, d))

    # ---- attention
    wmat = daos @ vs.transpose(-1, -2)  # w_ij = dao_i . v_j
    dscale = ((p - 1.0 / t) * wmat).sum(dim=(0, 1, 3, 4))
    dp = sh * wmat
    dl = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dbias = dl.sum(dim=(0, 1))
    dq = (dl @ ks) * scaling
    dk = (dl.transpose(-1, -2) @ qs) * scaling
    sdao = (sh * daos).to(dt).to(acc)
    dv = p.transpose(-1, -2) @ sdao + ((1.0 - sh) / t * daos).sum(dim=-2, keepdim=True)

    # ---- qk-LayerNorm backward -> the raw-component gradient dqkv
    dqr, dqn_scale, dqn_bias = layer_norm_bwd(unseq(dq), qhat, qrstd, qn_scale)
    dkr, dkn_scale, dkn_bias = layer_norm_bwd(unseq(dk), khat, krstd, kn_scale)
    dqkv = torch.stack([dqr.to(dt), dkr.to(dt), unseq(dv).to(dt)], dim=-2).to(acc)
    dqkv = dqkv.reshape(b, t, n, 3 * c)

    # ---- QKV projection and InstanceNorm1
    dwqkv = dqkv.reshape(-1, 3 * c).t() @ xn.reshape(-1, c)
    dbqkv = dqkv.sum(dim=(0, 1, 2))
    dx, din1_scale, din1_bias = _plane_norm_bwd(dqkv @ w1, xhat1, rstd1, in1_scale)
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


def _kernel_params(x, in1_scale, in1_bias, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias,
                   in2_scale, in2_bias, wout, bout, bias, scale_factor, heads):
    """The parameters as the C entries take them: float32 vectors, weights in
    the activation dtype, the four qk-LN vectors stacked, absent bias/scale
    filled in."""
    b, t, h, w, c = x.shape
    dev, dt = x.device, x.dtype

    def f32(a):
        return a.detach().to(device=dev, dtype=torch.float32).contiguous()

    p = dict(
        in1_w=f32(in1_scale), in1_b=f32(in1_bias),
        wqkv=wqkv.detach().to(device=dev, dtype=dt).contiguous(), bqkv=f32(bqkv),
        ln=torch.stack([f32(qn_scale), f32(qn_bias), f32(kn_scale), f32(kn_bias)]),
        in2_w=f32(in2_scale), in2_b=f32(in2_bias),
        wout=wout.detach().to(device=dev, dtype=dt).contiguous(), bout=f32(bout),
        bias=torch.zeros(heads, t, t, device=dev) if bias is None else f32(bias),
        scale=torch.ones(heads, device=dev) if scale_factor is None else f32(scale_factor),
    )
    _build.check_shapes(
        "mega_temporal_block", in1_scale=(p["in1_w"], (c,)), in1_bias=(p["in1_b"], (c,)),
        wqkv=(p["wqkv"], (3 * c, c)), bqkv=(p["bqkv"], (3 * c,)), ln=(p["ln"], (4, HEAD_DIM)),
        in2_scale=(p["in2_w"], (c,)), in2_bias=(p["in2_b"], (c,)), wout=(p["wout"], (c, c)),
        bout=(p["bout"], (c,)), bias=(p["bias"], (heads, t, t)),
        scale_factor=(p["scale"], (heads,)),
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
