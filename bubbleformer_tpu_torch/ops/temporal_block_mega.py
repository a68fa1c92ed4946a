"""K1: the whole temporal-attention branch, forward.

Counterpart of ``bubbleformer_tpu/ops/temporal_block_mega.py:
mega_temporal_block``: InstanceNorm1 -> QKV projection (heads-major
``[q|k|v]``) -> per-head qk-LayerNorm -> softmax attention over T with the T5
bias and the ``s*P + (1-s)/T`` blend -> InstanceNorm2 -> output projection,
with LayerScale gamma folded into the output weights by the caller and the
residual added outside.

:func:`mega_temporal_block` runs the hand-written CUDA kernel
(``csrc/temporal_block.cu``) on CUDA tensors and :func:`temporal_branch_plain`
on CPU tensors.  Both round where the TPU kernel rounds
(``temporal_block_mega.py:246-266``): xn, qkv, q/k/v, y2 and out in the
activation dtype; the attention output and every statistic in float32.
Forward only: the backward kernel comes with training.
"""
from __future__ import annotations

from typing import Optional

import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.layers.norm import layer_norm_f32
from bubbleformer_tpu_torch.ops.attention import axis_attention

_EPS = 1e-5
HEAD_DIM = 64  # the kernel's compile-time head dim
MAX_T = 8


def _plane_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """InstanceNorm of float32 ``(B, T, H, W, C)`` over (H, W), the TPU
    kernel's ``(x - mu) * inv * scale + bias`` form."""
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = torch.clamp((x * x).mean(dim=(2, 3), keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + _EPS) * weight.float() + bias.float()


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
    """Plain PyTorch version of K1; the arguments of :func:`mega_temporal_block`."""
    b, t, h, w, c = x.shape
    d = c // heads
    dt = x.dtype
    xn = _plane_norm(x.float(), in1_scale, in1_bias).to(dt)
    # Products of dtype values accumulated in float32, as on the tensor cores.
    qkv = (torch.matmul(xn.float(), wqkv.to(dt).float().t()) + bqkv.float()).to(dt)
    qkv = qkv.reshape(b, t, h, w, heads, 3, d)
    q = layer_norm_f32(qkv[..., 0, :], qn_scale, qn_bias).to(dt)
    k = layer_norm_f32(qkv[..., 1, :], kn_scale, kn_bias).to(dt)
    v = qkv[..., 2, :]

    def seq(a):  # (b, t, h, w, heads, d) -> (b, h, w, heads, t, d)
        return a.permute(0, 2, 3, 4, 1, 5)

    ao = axis_attention(seq(q), seq(k), seq(v), bias, scale_factor)  # float32
    ao = ao.permute(0, 4, 1, 2, 3, 5).reshape(b, t, h, w, c)
    y2 = _plane_norm(ao, in2_scale, in2_bias).to(dt)
    return (torch.matmul(y2.float(), wout.to(dt).float().t()) + bout.float()).to(dt)


def _temporal_branch_cuda(x, in1_scale, in1_bias, wqkv, bqkv, qn_scale, qn_bias, kn_scale,
                          kn_bias, in2_scale, in2_bias, wout, bout, bias, scale_factor, heads):
    b, t, h, w, c = x.shape
    n = h * w
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"mega_temporal_block kernel takes float32 or bfloat16, not {x.dtype}")
    if c != heads * HEAD_DIM or t > MAX_T or n % 16 or c % 32:
        raise ValueError(
            f"mega_temporal_block kernel needs head_dim {HEAD_DIM}, T <= {MAX_T}, "
            f"H*W % 16 == 0 and C % 32 == 0; got T={t}, H*W={n}, C={c}, heads={heads}"
        )
    if torch.is_grad_enabled() and any(
        a is not None and a.requires_grad for a in (x, wqkv, wout, bias, scale_factor)
    ):
        raise RuntimeError("mega_temporal_block's CUDA kernel is forward-only; call it under "
                           "torch.no_grad()")
    dev, dt = x.device, x.dtype

    def f32(a):
        return a.detach().to(device=dev, dtype=torch.float32).contiguous()

    x = x.contiguous()
    ln = torch.stack([f32(qn_scale), f32(qn_bias), f32(kn_scale), f32(kn_bias)])
    bias_t = (torch.zeros(heads, t, t, device=dev) if bias is None else f32(bias))
    scale = (torch.ones(heads, device=dev) if scale_factor is None else f32(scale_factor))
    _build.check_shapes(
        "mega_temporal_block", in1_scale=(in1_scale, (c,)), in1_bias=(in1_bias, (c,)),
        wqkv=(wqkv, (3 * c, c)), bqkv=(bqkv, (3 * c,)), ln=(ln, (4, HEAD_DIM)),
        in2_scale=(in2_scale, (c,)), in2_bias=(in2_bias, (c,)), wout=(wout, (c, c)),
        bout=(bout, (c,)), bias=(bias_t, (heads, t, t)), scale_factor=(scale, (heads,)),
    )
    args = dict(
        in1_w=f32(in1_scale), in1_b=f32(in1_bias),
        wqkv=wqkv.detach().to(device=dev, dtype=dt).contiguous(), bqkv=f32(bqkv), ln=ln,
        in2_w=f32(in2_scale), in2_b=f32(in2_bias),
        wout=wout.detach().to(device=dev, dtype=dt).contiguous(), bout=f32(bout),
        bias=bias_t, scale=scale,
        stats1=torch.empty(2, b * t, c, device=dev), ao=torch.empty(b * t * n, c, device=dev),
        stats2=torch.empty(2, b * t, c, device=dev), out=torch.empty_like(x),
    )
    lib = _build.library()
    err = lib.bf_temporal_block_fwd(
        _build.DTYPE_CODES[dt], x.data_ptr(), *(a.data_ptr() for a in args.values()),
        b, t, n, c, heads, _build.stream_handle(dev),
    )
    _build.check(lib, err, "bf_temporal_block_fwd")
    return args["out"]


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
    in ``x.dtype`` (the residual is the caller's).

    ``x``: ``(B, T, H, W, C)`` float32 or bfloat16.  ``wqkv`` ``(3C, C)`` and
    ``wout`` ``(C, C)`` are torch ``(out, in)`` weights (``wout``/``bout``
    already scaled by LayerScale gamma), cast to ``x.dtype`` for the
    products; every other parameter is used in float32.  ``bias``: the T5
    table ``(heads, T, T)``; ``scale_factor``: attn_scale ``(heads,)``.

    CPU tensors take :func:`temporal_branch_plain`; CUDA tensors launch the
    kernel (``mega_temporal_block.launches`` counts those launches).
    """
    args = (x, in1_scale, in1_bias, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias,
            in2_scale, in2_bias, wout, bout, bias, scale_factor)
    if x.device.type == "cpu":
        return temporal_branch_plain(*args, heads=heads)
    if x.device.type != "cuda":
        raise ValueError(f"mega_temporal_block: unsupported device {x.device}")
    out = _temporal_branch_cuda(*args, heads)
    mega_temporal_block.launches += 1
    return out


mega_temporal_block.launches = 0
