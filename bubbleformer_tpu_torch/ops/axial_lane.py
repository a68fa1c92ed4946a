"""K2: the axial row + column attention core, forward.

Counterpart of ``bubbleformer_tpu/ops/axial_lane.py:
lane_axial_attention_from_x``: the QKV projection of the InstanceNorm1
output (a plain matmul, as it was XLA on the TPU), then per-head
qk-LayerNorm, attention along each row (over W, ``bias_x``, ``scale_x``) and
each column (over H, ``bias_y``, ``scale_y``) with the attn_scale blend folded
into the probabilities, and the mean of the two directions.

:func:`lane_axial_attention` runs the hand-written CUDA kernel
(``csrc/axial_attention.cu``) on CUDA tensors and :func:`axial_attention_plain`
on CPU tensors.  Both round where the lane kernel rounds: qkv, q/k (after
LN), the blended probabilities and each direction's output in the activation
dtype (``axial_lane.py:_axis_fwd``, ``:844-848``).  Forward only.
"""
from __future__ import annotations

from typing import Optional

import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.layers.norm import layer_norm_f32
from bubbleformer_tpu_torch.ops.attention import axis_attention

HEAD_DIM = 64  # the kernel's compile-time head dim
MAX_LINE = 64  # longest row or column the kernel stages in shared memory


def axial_attention_plain(
    qkv: torch.Tensor, qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of K2; the arguments of :func:`lane_axial_attention`."""
    bt, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    dt = qkv.dtype
    q5 = qkv.reshape(bt, h, w, heads, 3, d)
    q = layer_norm_f32(q5[..., 0, :], qn_scale, qn_bias).to(dt)
    k = layer_norm_f32(q5[..., 1, :], kn_scale, kn_bias).to(dt)
    v = q5[..., 2, :]

    def rows(a):  # (bt, h, w, heads, d) -> (bt, h, heads, w, d)
        return a.permute(0, 1, 3, 2, 4)

    def cols(a):  # (bt, h, w, heads, d) -> (bt, w, heads, h, d)
        return a.permute(0, 2, 3, 1, 4)

    o_r = axis_attention(rows(q), rows(k), rows(v), bias_x, scale_x, fold_dtype=dt).to(dt)
    o_r = o_r.permute(0, 1, 3, 2, 4).reshape(bt, h, w, c)
    o_c = axis_attention(cols(q), cols(k), cols(v), bias_y, scale_y, fold_dtype=dt).to(dt)
    o_c = o_c.permute(0, 3, 1, 2, 4).reshape(bt, h, w, c)
    return (0.5 * (o_r.float() + o_c.float())).to(dt)


def _axial_cuda(qkv, qn_scale, qn_bias, kn_scale, kn_bias, bias_x, bias_y, scale_x, scale_y,
                heads):
    bt, h, w, c3 = qkv.shape
    c = c3 // 3
    if qkv.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"lane_axial_attention kernel takes float32 or bfloat16, not {qkv.dtype}")
    if c3 != 3 * c or c != heads * HEAD_DIM or max(h, w) > MAX_LINE:
        raise ValueError(
            f"lane_axial_attention kernel needs head_dim {HEAD_DIM} and max(H, W) <= "
            f"{MAX_LINE}; got {h}x{w}, C={c}, heads={heads}"
        )
    if torch.is_grad_enabled() and any(
        a is not None and a.requires_grad for a in (qkv, bias_x, bias_y, scale_x, scale_y)
    ):
        raise RuntimeError("lane_axial_attention's CUDA kernel is forward-only; call it under "
                           "torch.no_grad()")
    dev = qkv.device

    def f32(a):
        return a.detach().to(device=dev, dtype=torch.float32).contiguous()

    ones = torch.ones(heads, device=dev)
    qkv = qkv.contiguous()
    ln = torch.stack([f32(qn_scale), f32(qn_bias), f32(kn_scale), f32(kn_bias)])
    bx = torch.zeros(heads, w, w, device=dev) if bias_x is None else f32(bias_x)
    by = torch.zeros(heads, h, h, device=dev) if bias_y is None else f32(bias_y)
    scale = torch.stack([ones if scale_x is None else f32(scale_x),
                         ones if scale_y is None else f32(scale_y)], dim=1).contiguous()
    _build.check_shapes("lane_axial_attention", ln=(ln, (4, HEAD_DIM)),
                        bias_x=(bx, (heads, w, w)), bias_y=(by, (heads, h, h)),
                        scale=(scale, (heads, 2)))
    row_out = torch.empty(bt, h, w, c, device=dev)
    out = torch.empty(bt, h, w, c, device=dev, dtype=qkv.dtype)
    lib = _build.library()
    err = lib.bf_axial_attention_fwd(
        _build.DTYPE_CODES[qkv.dtype], qkv.data_ptr(), ln.data_ptr(), bx.data_ptr(),
        by.data_ptr(), scale.data_ptr(), row_out.data_ptr(), out.data_ptr(),
        bt, h, w, c, heads, _build.stream_handle(dev),
    )
    _build.check(lib, err, "bf_axial_attention_fwd")
    return out


def lane_axial_attention(
    qkv: torch.Tensor, qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int,
) -> torch.Tensor:
    """Averaged row/column attention ``(BT, H, W, C)`` from the interleaved
    QKV tensor ``qkv`` ``(BT, H, W, 3C)`` (float32 or bfloat16).

    ``bias_x`` ``(heads, W, W)`` / ``bias_y`` ``(heads, H, H)``: the T5
    tables; ``scale_x`` / ``scale_y`` ``(heads,)``: per-axis attn_scale.
    CPU tensors take :func:`axial_attention_plain`; CUDA tensors launch the
    kernel (``lane_axial_attention.launches`` counts those launches).
    """
    args = (qkv, qn_scale, qn_bias, kn_scale, kn_bias, bias_x, bias_y, scale_x, scale_y)
    if qkv.device.type == "cpu":
        return axial_attention_plain(*args, heads=heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"lane_axial_attention: unsupported device {qkv.device}")
    out = _axial_cuda(*args, heads)
    lane_axial_attention.launches += 1
    return out


lane_axial_attention.launches = 0


def project_qkv(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor) -> torch.Tensor:
    """``(x @ W^T + b)`` accumulated and biased in float32, then rounded to
    ``x.dtype`` — the lane wrapper's XLA projection (``axial_lane.py:988-994``)."""
    y = torch.addmm(bqkv.float(), x.reshape(-1, x.shape[-1]).float(),
                    wqkv.to(x.dtype).float().t())
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)


def lane_axial_attention_from_x(
    x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
    qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int,
) -> torch.Tensor:
    """Axial attention from the InstanceNorm1 output ``x`` ``(BT, H, W, C)``:
    the QKV projection (``wqkv`` torch ``(3C, C)``), then
    :func:`lane_axial_attention`."""
    return lane_axial_attention(
        project_qkv(x, wqkv, bqkv), qn_scale, qn_bias, kn_scale, kn_bias,
        bias_x, bias_y, scale_x, scale_y, heads=heads,
    )
