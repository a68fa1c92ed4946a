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
``csrc/axial_lane_px.cu``'s kernels, chosen by dtype in one place
(:func:`px_kernels`), any other device raises.  bfloat16 runs on Hopper's
own units (:func:`px_hopper_fwd`, :func:`px_hopper_bwd`): every product on
the TMA + wgmma GEMM (``csrc/hopper_gemm.cuh``), the attention on K2's
tensor-core kernels (``csrc/lane_hopper.cuh``, its backward in the kLanePx
rounding), dW over both directions in one fixed-order split-K sum and every
parameter gradient repeating bit for bit; float32 keeps the first chain
(:func:`px_line_fwd`, :func:`px_line_bwd`: block_gemm.cuh's FMA tile and the
line kernels).  ``lane_px_attention.launches`` and
``lane_px_attention_bwd.launches`` count every call on the card, each path's
functions their own launches.  Both take K2's envelope (head dims 16 and
64, lines of at most 512 tokens) and C a multiple of 32; any other shape
raises on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.layers.norm import accumulation_dtype
from bubbleformer_tpu_torch.ops.axial_lane import (
    LINE_TILE,
    LineAttention,
    MODE_LANE_PX,
    axial_attention_plain,
    check_line_shape,
    lane_bwd_directions,
    lane_bwd_scratch,
    line_bwd_scratch,
    line_tables,
    project_qkv,
)
from bubbleformer_tpu_torch.ops.hopper_gemm import split_k_plan

GEMM_K_CHUNK = 32  # the FMA tile's K chunk (csrc/block_gemm.cuh kKC): C a multiple of it


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


def _tables(p) -> tuple:
    return p["bqkv"].data_ptr(), p["ln"].data_ptr(), p["bias_x"].data_ptr(), \
        p["bias_y"].data_ptr(), p["scale"].data_ptr()


def _grads(g: dict, params) -> tuple:
    """The backward's outputs in the order of :func:`lane_px_bwd_plain`, None
    where the argument is absent."""
    bias_x, bias_y, scale_x, scale_y = params[-4:]
    return (g["dx"], g["dwqkv"], g["dbqkv"], g["dln"][0], g["dln"][1], g["dln"][2], g["dln"][3],
            None if bias_x is None else g["dbias_x"], None if bias_y is None else g["dbias_y"],
            None if scale_x is None else g["dscale"][:, 0],
            None if scale_y is None else g["dscale"][:, 1])


def _param_grads(dev, c: int, d: int, heads: int, h: int, w: int, zero: bool) -> dict:
    """The float32 parameter gradients' buffers (zeroed where the kernels
    add into them)."""
    new = torch.zeros if zero else torch.empty
    f32 = dict(device=dev, dtype=torch.float32)
    return dict(dwqkv=new(3 * c, c, **f32), dbqkv=new(3 * c, **f32),
                dln=torch.empty(4, d, **f32), dbias_x=torch.empty(heads, w, w, **f32),
                dbias_y=torch.empty(heads, h, h, **f32), dscale=torch.empty(heads, 2, **f32))


def px_line_fwd(x: torch.Tensor, *params, heads: int) -> torch.Tensor:
    """K9's float32 forward (``bf_axial_lane_px_fwd``): the projection on
    block_gemm.cuh's tile into a qkv scratch, then the line kernels in K2's
    lane flavour; counts ``px_line_fwd.launches``."""
    what = "lane_px_attention (bf_axial_lane_px_fwd)"
    d = _check_shape(what, x, heads)
    p = _px_params(x, *params, heads, what)
    bt, h, w, c = x.shape
    dev = x.device
    x = x.contiguous()  # held by a name until the launches are queued
    qkv = torch.empty(bt * h * w, 3 * c, device=dev)
    row_out = torch.empty(bt * h * w, c, device=dev)
    out = torch.empty(bt, h, w, c, device=dev)
    lib = _build.library()
    err = lib.bf_axial_lane_px_fwd(d, x.data_ptr(), p["wqkv"].data_ptr(), *_tables(p),
                                   qkv.data_ptr(), row_out.data_ptr(), out.data_ptr(), bt, h, w,
                                   c, heads, _build.stream_handle(dev))
    _build.check(lib, err, what)
    px_line_fwd.launches += 1
    return out


def px_line_bwd(do: torch.Tensor, x: torch.Tensor, *params, heads: int) -> tuple:
    """K9's float32 backward (``bf_axial_lane_px_bwd``): the projection
    again, then per direction the line kernels' kLanePx backward and its
    products on block_gemm.cuh's tile (dW and db float32 atomic sums, whose
    last bits vary from run to run; the table, scale and LN gradients the line
    kernels' fixed-order sums); counts ``px_line_bwd.launches``."""
    what = "lane_px_attention_bwd (bf_axial_lane_px_bwd)"
    d = _check_shape(what, x, heads)
    p = _px_params(x, *params, heads, what)
    bt, h, w, c = x.shape
    _build.check_shapes(what, do=(do, x.shape))
    dev = x.device
    r = bt * h * w
    g = dict(dx=torch.empty(bt, h, w, c, device=dev), **_param_grads(dev, c, d, heads, h, w, True))
    x, do = x.contiguous(), do.to(x.dtype).contiguous()  # held until the launches are queued
    wqkv_t = p["wqkv"].t().contiguous()
    qkv = torch.empty(r, 3 * c, device=dev)
    dqkv = torch.empty(r, 3 * c, device=dev)
    stats = torch.empty(bt, heads, h * w, 3, device=dev) if max(h, w) > LINE_TILE else None
    part, plan = line_bwd_scratch(bt, h, w, heads, d, dev)
    lib = _build.library()
    err = lib.bf_axial_lane_px_bwd(
        d, x.data_ptr(), do.data_ptr(), p["wqkv"].data_ptr(), wqkv_t.data_ptr(), *_tables(p),
        qkv.data_ptr(), dqkv.data_ptr(), None if stats is None else stats.data_ptr(),
        part.data_ptr(), *plan, *(t.data_ptr() for t in g.values()), bt, h, w, c, heads,
        _build.stream_handle(dev))
    _build.check(lib, err, what)
    px_line_bwd.launches += 1
    return _grads(g, params)


def px_hopper_fwd(x: torch.Tensor, *params, heads: int) -> torch.Tensor:
    """K9's bf16 forward (``bf_lane_px_hopper_fwd``): the QKV product on the
    Hopper GEMM into a bf16 scratch, then K2's Hopper forward; counts
    ``px_hopper_fwd.launches``."""
    what = "lane_px_attention (bf_lane_px_hopper_fwd)"
    d = _check_shape(what, x, heads)
    p = _px_params(x, *params, heads, what)
    bt, h, w, c = x.shape
    dev, dt = x.device, x.dtype
    x = x.contiguous()  # held by a name until the launches are queued
    qkv = torch.empty(bt * h * w, 3 * c, device=dev, dtype=dt)
    row_out = torch.empty(bt * h * w, c, device=dev, dtype=dt)
    out = torch.empty(bt, h, w, c, device=dev, dtype=dt)
    _build.check_tma(what, x=x, wqkv=p["wqkv"], qkv=qkv, row_out=row_out, out=out)
    lib = _build.library()
    err = lib.bf_lane_px_hopper_fwd(d, x.data_ptr(), p["wqkv"].data_ptr(), *_tables(p),
                                    qkv.data_ptr(), row_out.data_ptr(), out.data_ptr(), bt, h, w,
                                    c, heads, _build.stream_handle(dev))
    _build.check(lib, err, what)
    px_hopper_fwd.launches += 1
    return out


def px_hopper_bwd(do: torch.Tensor, x: torch.Tensor, *params, heads: int) -> tuple:
    """K9's bf16 backward (``bf_lane_px_hopper_bwd``): the product again, K2's
    Hopper backward a direction at a time, each direction's dqkv rounded on
    its own and projected back before the next: dW over both directions'
    split-K ranges (:func:`~bubbleformer_tpu_torch.ops.hopper_gemm.
    split_k_plan`) added in one fixed order, db from per-plane sums in a
    fixed order, dx as two rounded products added in bf16.  Every parameter
    gradient repeats bit for bit; counts ``px_hopper_bwd.launches``."""
    what = "lane_px_attention_bwd (bf_lane_px_hopper_bwd)"
    d = _check_shape(what, x, heads)
    p = _px_params(x, *params, heads, what)
    bt, h, w, c = x.shape
    _build.check_shapes(what, do=(do, x.shape))
    dev, dt = x.device, x.dtype
    r = bt * h * w
    g = dict(dx=torch.empty(bt, h, w, c, device=dev, dtype=dt),
             **_param_grads(dev, c, d, heads, h, w, False))
    x, do = x.contiguous(), do.to(dt).contiguous()  # held until the launches are queued
    wqkv_t = p["wqkv"].t().contiguous()
    qkv = torch.empty(r, 3 * c, device=dev, dtype=dt)
    dqkv = torch.empty(r, 3 * c, device=dev, dtype=dt)
    sums = torch.empty(2, 2 * bt, 3 * c, device=dev)
    bounds = split_k_plan(r, 3 * c, c)
    part_w = torch.empty(2 * (len(bounds) - 1) * 3 * c * c, device=dev)
    _build.check_tma(what, x=x, do=do, wqkv=p["wqkv"], wqkv_t=wqkv_t, qkv=qkv, dqkv=dqkv,
                     dx=g["dx"])
    lane_part, plan = lane_bwd_scratch(bt, h, w, heads, d, dev, MODE_LANE_PX)
    lib = _build.library()
    err = lib.bf_lane_px_hopper_bwd(
        d, x.data_ptr(), do.data_ptr(), p["wqkv"].data_ptr(), wqkv_t.data_ptr(), *_tables(p),
        qkv.data_ptr(), dqkv.data_ptr(), sums.data_ptr(), part_w.data_ptr(),
        _build.int32_array(bounds), len(bounds) - 1, lane_part.data_ptr(), *plan,
        *(t.data_ptr() for t in g.values()), bt, h, w, c, heads, _build.stream_handle(dev))
    _build.check(lib, err, what)
    px_hopper_bwd.launches += 1
    return _grads(g, params)


px_line_fwd.launches = px_line_bwd.launches = 0
px_hopper_fwd.launches = px_hopper_bwd.launches = 0


def px_kernels(dtype: torch.dtype) -> tuple:
    """K9's ``(forward, backward)`` kernels on the card for ``dtype``: the
    Hopper chain for bfloat16, the first chain for float32; any other dtype
    raises."""
    if dtype == torch.bfloat16:
        return px_hopper_fwd, px_hopper_bwd
    if dtype == torch.float32:
        return px_line_fwd, px_line_bwd
    raise TypeError(f"lane_px_attention kernel takes float32 or bfloat16, not {dtype}")


def lane_px_attention_bwd(do: torch.Tensor, x: torch.Tensor, *params, heads: int) -> tuple:
    """K9's backward: the gradients :func:`lane_px_bwd_plain` returns.  CPU
    tensors take the plain version; CUDA tensors the kernels
    :func:`px_kernels` picks by dtype, and count
    ``lane_px_attention_bwd.launches``."""
    if x.device.type == "cpu":
        return lane_px_bwd_plain(do, x, *params, heads=heads)
    if x.device.type != "cuda":
        raise ValueError(f"lane_px_attention_bwd: unsupported device {x.device}")
    grads = px_kernels(x.dtype)[1](do, x, *params, heads=heads)
    lane_px_attention_bwd.launches += 1
    return grads


def _px_fwd(x, *params, heads):
    if x.device.type == "cpu":
        return lane_px_plain(x, *params, heads=heads)
    if x.device.type != "cuda":
        raise ValueError(f"lane_px_attention: unsupported device {x.device}")
    out = px_kernels(x.dtype)[0](x, *params, heads=heads)
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
