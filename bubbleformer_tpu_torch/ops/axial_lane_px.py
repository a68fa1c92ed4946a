"""K9: the lane axial attention with the QKV projection inside the kernels.

Counterpart of ``bubbleformer_tpu/ops/axial_lane.py:_make_lane_axial_px``
(forward ``_fwd_kernel_px :399``, backward ``_bwd_kernel_px :426``, VJP
``:570-593``), reached as there through ``lane_axial_attention_from_x(...,
proj="kernel")`` or ``BUBBLEFORMER_LANE_PROJ=kernel``: K2's function of the
InstanceNorm1 output ``x`` ``(BT, H, W, C)`` and the QKV weight, with the
projection ``x . W^T + b`` computed by the kernels.  The projected qkv is
scratch of each call; the backward keeps ``x``, the weights and the tables
and projects again (the TPU kernel's residuals are its inputs,
``fused_fwd :575-577``), so no 3C-wide tensor outlives a call.

Its rounding is the TPU kernel's, which differs from K2's route in the
backward:

* qkv = ``dtype(x . dtype(W)^T + b)``, float32 sums; staging, each
  direction's output and ``out = dtype(0.5 (o_r + o_c))`` as K2's lane
  flavour (``:958``);
* each direction's ``dqkv`` (from ``dtype(0.5 dout)``) is rounded to the
  activation dtype (``:462-470``) and projected back on its own: ``dW`` and
  ``db`` are float32 sums over both directions and are never rounded
  (``:473-476``; the XLA route hands the float32 parameter a gradient
  rounded to the activation dtype), each direction's ``dx`` is rounded and
  the two are added in the activation dtype (``:477-480``);
* the qk-LN, table and scale gradients are K2's.

:func:`lane_px_attention` is a ``torch.autograd.Function``: CPU tensors take
:func:`lane_px_plain` and :func:`lane_px_bwd_plain`, CUDA tensors launch
``csrc/axial_lane_px.cu`` (``lane_px_attention.launches`` and
``lane_px_attention_bwd.launches`` count them), any other device raises.
The kernels take K2's envelope (head dims 16 and 64, lines of at most 512
tokens) and C a multiple of 32; any other shape raises on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.layers.norm import accumulation_dtype
from bubbleformer_tpu_torch.ops.axial_lane import (
    LINE_TILE,
    LineAttention,
    axial_attention_plain,
    check_line_shape,
    lane_bwd_directions,
    line_tables,
    project_qkv,
)

GEMM_K_CHUNK = 32  # the GEMM tile's K chunk (csrc/block_gemm.cuh kKC): C a multiple of it


def lane_px_plain(
    x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
    qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of K9's forward: the projection, then K2's
    forward; the arguments of :func:`lane_px_attention`."""
    return axial_attention_plain(project_qkv(x, wqkv, bqkv), qn_scale, qn_bias, kn_scale,
                                 kn_bias, bias_x, bias_y, scale_x, scale_y, heads=heads)


def lane_px_bwd_plain(
    do: torch.Tensor, x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
    qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int,
) -> tuple:
    """Plain PyTorch version of K9's backward: the gradients of ``(x, wqkv,
    bqkv, qn_scale, qn_bias, kn_scale, kn_bias, bias_x, bias_y, scale_x,
    scale_y)`` for the output gradient ``do``, with the TPU kernel's rounding
    (module docstring): ``dx`` in ``x.dtype``, the rest float32 (float64 for
    float64 input), None where the argument is absent."""
    dt = x.dtype
    acc = accumulation_dtype(dt)
    c = x.shape[-1]
    dqkv_r, dqkv_c, *rest = lane_bwd_directions(
        do, project_qkv(x, wqkv, bqkv), qn_scale, qn_bias, kn_scale, kn_bias, bias_x, bias_y,
        scale_x, scale_y, heads=heads)
    x2 = x.reshape(-1, c).to(acc)
    w = wqkv.to(dt).to(acc)
    dw = db = dx = None
    for dqkv in (dqkv_r, dqkv_c):
        g = dqkv.reshape(-1, 3 * c).to(acc)
        dw = g.t() @ x2 if dw is None else dw + g.t() @ x2
        db = g.sum(0) if db is None else db + g.sum(0)
        dx_dir = (g @ w).to(dt)
        dx = dx_dir if dx is None else (dx.to(acc) + dx_dir.to(acc)).to(dt)
    return (dx.reshape(x.shape), dw, db, *rest)


def _check_shape(what: str, x: torch.Tensor, heads: int) -> int:
    bt, h, w, c = x.shape
    d = check_line_shape(what, x.shape, x.dtype, h, w, c, heads)
    if c % GEMM_K_CHUNK:
        raise ValueError(f"{what} kernel takes C a multiple of {GEMM_K_CHUNK}; got "
                         f"{tuple(x.shape)} (C={c})")
    return d


def _px_params(x, wqkv, bqkv, qn_scale, qn_bias, kn_scale, kn_bias, bias_x, bias_y, scale_x,
               scale_y, heads, what):
    """The kernels' weights in the activation dtype and float32 vectors and
    tables (absent tables zero, absent scales one), shapes checked."""
    bt, h, w, c = x.shape
    d = c // heads
    dev = x.device
    ln = torch.stack([a.detach().to(device=dev, dtype=torch.float32)
                      for a in (qn_scale, qn_bias, kn_scale, kn_bias)]).contiguous()
    p = dict(wqkv=wqkv.detach().to(device=dev, dtype=x.dtype).contiguous(),
             bqkv=bqkv.detach().to(device=dev, dtype=torch.float32).contiguous(), ln=ln,
             **line_tables(bias_x, bias_y, scale_x, scale_y, heads, h, w, dev, what))
    _build.check_shapes(what, wqkv=(p["wqkv"], (3 * c, c)), bqkv=(p["bqkv"], (3 * c,)),
                        ln=(ln, (4, d)))
    return p


def lane_px_fwd_cuda(x: torch.Tensor, *params, heads: int) -> torch.Tensor:
    """Launch ``bf_axial_lane_px_fwd``: the projection into a qkv scratch,
    then K2's lane flavour, rows then columns; ``(BT, H, W, C)``."""
    what = "lane_px_attention"
    d = _check_shape(what, x, heads)
    p = _px_params(x, *params, heads, what)
    bt, h, w, c = x.shape
    dev, dt = x.device, x.dtype
    x = x.contiguous()  # held by a name until the launches are queued
    qkv = torch.empty(bt * h * w, 3 * c, device=dev, dtype=dt)
    row_out = torch.empty(bt * h * w, c, device=dev)
    out = torch.empty(bt, h, w, c, device=dev, dtype=dt)
    lib = _build.library()
    err = lib.bf_axial_lane_px_fwd(
        _build.DTYPE_CODES[dt], d, x.data_ptr(), p["wqkv"].data_ptr(), p["bqkv"].data_ptr(),
        p["ln"].data_ptr(), p["bias_x"].data_ptr(), p["bias_y"].data_ptr(),
        p["scale"].data_ptr(), qkv.data_ptr(), row_out.data_ptr(), out.data_ptr(), bt, h, w, c,
        heads, _build.stream_handle(dev),
    )
    _build.check(lib, err, f"{what} (bf_axial_lane_px_fwd)")
    return out


def lane_px_bwd_cuda(do: torch.Tensor, x: torch.Tensor, *params, heads: int) -> tuple:
    """Launch ``bf_axial_lane_px_bwd``: the gradients :func:`lane_px_bwd_plain`
    returns, None where the argument is absent."""
    what = "lane_px_attention_bwd"
    d = _check_shape(what, x, heads)
    p = _px_params(x, *params, heads, what)
    bt, h, w, c = x.shape
    _build.check_shapes(what, do=(do, x.shape))
    dev, dt = x.device, x.dtype
    r = bt * h * w

    def zeros(*shape):
        return torch.zeros(*shape, device=dev)

    grads = dict(dx=torch.empty(bt, h, w, c, device=dev, dtype=dt), dwqkv=zeros(3 * c, c),
                 dbqkv=zeros(3 * c), dln=zeros(4, d), dbias_x=zeros(heads, w, w),
                 dbias_y=zeros(heads, h, h), dscale=zeros(heads, 2))
    x, do = x.contiguous(), do.to(dt).contiguous()  # held until the launches are queued
    wqkv_t = p["wqkv"].t().contiguous()
    qkv = torch.empty(r, 3 * c, device=dev, dtype=dt)
    dqkv = torch.empty(r, 3 * c, device=dev, dtype=dt)
    stats = torch.empty(bt, heads, h * w, 3, device=dev) if max(h, w) > LINE_TILE else None
    lib = _build.library()
    err = lib.bf_axial_lane_px_bwd(
        _build.DTYPE_CODES[dt], d, x.data_ptr(), do.data_ptr(), p["wqkv"].data_ptr(),
        wqkv_t.data_ptr(), p["bqkv"].data_ptr(), p["ln"].data_ptr(), p["bias_x"].data_ptr(),
        p["bias_y"].data_ptr(), p["scale"].data_ptr(), qkv.data_ptr(), dqkv.data_ptr(),
        None if stats is None else stats.data_ptr(),
        *(g.data_ptr() for g in grads.values()), bt, h, w, c, heads, _build.stream_handle(dev),
    )
    _build.check(lib, err, f"{what} (bf_axial_lane_px_bwd)")
    g = grads
    bias_x, bias_y, scale_x, scale_y = params[-4:]
    return (g["dx"], g["dwqkv"], g["dbqkv"], g["dln"][0], g["dln"][1], g["dln"][2], g["dln"][3],
            None if bias_x is None else g["dbias_x"], None if bias_y is None else g["dbias_y"],
            None if scale_x is None else g["dscale"][:, 0],
            None if scale_y is None else g["dscale"][:, 1])


def lane_px_attention_bwd(do: torch.Tensor, x: torch.Tensor, *params, heads: int) -> tuple:
    """K9's backward: the gradients :func:`lane_px_bwd_plain` returns.  CPU
    tensors take the plain version; CUDA tensors launch
    ``bf_axial_lane_px_bwd`` and count ``lane_px_attention_bwd.launches``.  The
    parameter gradients are float32 atomic sums: their last bits vary from
    run to run."""
    if x.device.type == "cpu":
        return lane_px_bwd_plain(do, x, *params, heads=heads)
    if x.device.type != "cuda":
        raise ValueError(f"lane_px_attention_bwd: unsupported device {x.device}")
    grads = lane_px_bwd_cuda(do, x, *params, heads=heads)
    lane_px_attention_bwd.launches += 1
    return grads


def _px_fwd(x, *params, heads):
    if x.device.type == "cpu":
        return lane_px_plain(x, *params, heads=heads)
    if x.device.type != "cuda":
        raise ValueError(f"lane_px_attention: unsupported device {x.device}")
    out = lane_px_fwd_cuda(x, *params, heads=heads)
    lane_px_attention.launches += 1
    return out


def lane_px_attention(
    x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
    qn_scale: torch.Tensor, qn_bias: torch.Tensor,
    kn_scale: torch.Tensor, kn_bias: torch.Tensor,
    bias_x: Optional[torch.Tensor] = None, bias_y: Optional[torch.Tensor] = None,
    scale_x: Optional[torch.Tensor] = None, scale_y: Optional[torch.Tensor] = None,
    *, heads: int,
) -> torch.Tensor:
    """K9: averaged row/column attention ``(BT, H, W, C)`` of the QKV
    projection of ``x`` ``(BT, H, W, C)`` (float32 or bfloat16), differentiable
    in every argument.  ``wqkv`` torch ``(3C, C)``, cast to ``x.dtype`` for
    the product, ``bqkv`` ``(3C,)``; the other arguments as for
    :func:`~bubbleformer_tpu_torch.ops.axial_lane.lane_axial_attention`.  Its
    autograd node keeps the arguments only (the forward's qkv is scratch)."""
    return LineAttention.apply(_px_fwd, lane_px_attention_bwd, {"heads": heads}, x, wqkv, bqkv,
                               qn_scale, qn_bias, kn_scale, kn_bias, bias_x, bias_y, scale_x,
                               scale_y)


lane_px_attention.launches = 0
lane_px_attention_bwd.launches = 0
