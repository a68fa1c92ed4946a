"""K8: attention over many short lines with a bias table and the attn_scale
blend, forward and backward — the ``flash`` route of both branches.

Counterpart of ``bubbleformer_tpu/ops/axial_pallas.py:
flash_packed_attention``: ``q``, ``k``, ``v`` ``(heads, M, n, d)``, M
independent lines of n tokens per head, a bias table ``(heads, n, n)`` and
a scale ``(heads,)``:

    P     = softmax(q k^T / sqrt(d) + bias)     per line, in float32
    P_eff = s P + (1 - s) / n
    out   = dtype(P_eff v)

from q, k and v cast to float32, rounded once (``_fwd_kernel :66``).  Its
backward (``_bwd_kernel :82``) works in float32 throughout and rounds
``dq``, ``dk``, ``dv`` once; the bias gradient is the sum of ``dS`` over
the M lines and the scale gradient ``sum dP_eff (P - 1/n)``, both float32.
The TPU kernel packs ``pick_flash_group`` lines into one super-line with a
block-diagonal -1e9 mask to fill its matrix unit; ``exp(-1e9)`` is exactly 0
in float32, so that is per-line attention, which is what the port computes.

This is not the XLA ``packed`` route
(:func:`~bubbleformer_tpu_torch.ops.attention.packed_attention`): that one
rounds the probabilities to the activation dtype before their product with
``v`` and blends in that dtype, so in bfloat16 the two differ.

:func:`flash_packed_attention` is a ``torch.autograd.Function``.  On CUDA
tensors its forward and backward launch ``csrc/axial_flash.cu`` (the line
kernels in their kFlash flavour: head dims 16 and 64, lines of up to 512
tokens; any other shape raises); on CPU tensors :func:`flash_plain` and
:func:`flash_bwd_plain`; on any other device they raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.layers.norm import accumulation_dtype
from bubbleformer_tpu_torch.ops.axial_lane import (
    HEAD_DIMS,
    LINE_TILE,
    MAX_LINE,
    LineAttention,
    line_bwd_scratch,
)


def pick_flash_group(m: int, n: int, cap: int = 512) -> int:
    """The TPU kernel's packing group: the largest power-of-two G dividing M
    with G*n <= cap (``axial_pallas.py:40``).  The port does not pack."""
    g = 1
    while g * 2 * n <= cap and m % (g * 2) == 0:
        g *= 2
    return g


def _probs(q, k, bias):
    """Per-line softmax probabilities ``(heads, M, n, n)`` in q's dtype."""
    d = q.shape[-1]
    logits = q @ k.transpose(-1, -2) * d**-0.5
    if bias is not None:
        logits = logits + bias.to(q.dtype)[:, None]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _scale(scale_factor, heads, dev, acc):
    s = torch.ones(heads, device=dev, dtype=acc) if scale_factor is None else scale_factor.to(acc)
    return s.reshape(heads, 1, 1, 1)


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                scale_factor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K8's forward; the arguments of
    :func:`flash_packed_attention`.  Float32 throughout (float64 for float64
    inputs), rounded once."""
    heads, _, n, _ = q.shape
    dt, acc = q.dtype, accumulation_dtype(q.dtype)
    p = _probs(q.to(acc), k.to(acc), bias)
    s = _scale(scale_factor, heads, q.device, acc)
    return ((s * p + (1.0 - s) * (1.0 / n)) @ v.to(acc)).to(dt)


def flash_bwd_plain(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    scale_factor: Optional[torch.Tensor] = None) -> tuple:
    """Plain PyTorch version of K8's backward: explicit formulas, no autograd.

    Returns the gradients of ``(q, k, v, bias, scale_factor)`` for the
    output gradient ``do``: ``dq``, ``dk``, ``dv`` in ``q.dtype``, the rest
    float32 (None where the argument is absent).  With ``G = do v^T``:
    ``dscale = sum (P - 1/n) G``, ``dS = P (s G - rowsum(s G P))``, ``dbias
    = sum over lines of dS``, ``dq = dS k / sqrt(d)``, ``dk = dS^T q /
    sqrt(d)``, ``dv = P_eff^T do`` (``axial_pallas.py:113-143``)."""
    heads, _, n, d = q.shape
    dt, acc = q.dtype, accumulation_dtype(q.dtype)
    qa, ka, va, da = q.to(acc), k.to(acc), v.to(acc), do.to(acc)
    p = _probs(qa, ka, bias)
    s = _scale(scale_factor, heads, q.device, acc)
    g = da @ va.transpose(-1, -2)
    dscale = ((p - 1.0 / n) * g).sum(dim=(1, 2, 3))
    dp = s * g
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    p_eff = s * p + (1.0 - s) * (1.0 / n)
    dq = ds @ ka * d**-0.5
    dk = ds.transpose(-1, -2) @ qa * d**-0.5
    dv = p_eff.transpose(-1, -2) @ da
    return (dq.to(dt), dk.to(dt), dv.to(dt), None if bias is None else ds.sum(dim=1),
            None if scale_factor is None else dscale)


def _cuda_args(q, k, v, bias, scale_factor, what):
    """K8's envelope checked (one float32 or bfloat16 dtype, head dim 16 or
    64, lines of at most ``MAX_LINE`` tokens), and its float32 tables: bias
    ``(heads, n, n)`` (absent: zero) and scale ``(heads, 2)`` (absent: one;
    the kernels read column 0)."""
    heads, m, n, d = q.shape
    _build.check_shapes(what, k=(k, q.shape), v=(v, q.shape))
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what} kernel takes q, k, v of one dtype, float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS or n > MAX_LINE or m * n * d >= 2**31:
        raise ValueError(f"{what} kernel takes head_dim in {HEAD_DIMS}, lines of at most "
                         f"{MAX_LINE} tokens and fewer than 2^31 values per tensor; got "
                         f"q {tuple(q.shape)} (heads, M, n, d)")
    dev = q.device
    s = (torch.ones(heads, device=dev) if scale_factor is None
         else scale_factor.detach().to(device=dev, dtype=torch.float32))
    tables = dict(
        bias=(torch.zeros(heads, n, n, device=dev) if bias is None
              else bias.detach().to(device=dev, dtype=torch.float32).contiguous()),
        scale=torch.stack([s, s], dim=1).contiguous(),
    )
    _build.check_shapes(what, bias=(tables["bias"], (heads, n, n)),
                        scale=(tables["scale"], (heads, 2)))
    return tables


def flash_fwd_cuda(q, k, v, bias=None, scale_factor=None) -> torch.Tensor:
    """Launch ``csrc/axial_flash.cu``'s forward: ``(heads, M, n, d)``."""
    heads, m, n, d = q.shape
    what = "flash_packed_attention"
    p = _cuda_args(q, k, v, bias, scale_factor, what)
    qkv3 = torch.stack([q, k, v]).contiguous()
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    lib = _build.library()
    err = lib.bf_axial_flash_fwd(
        _build.DTYPE_CODES[q.dtype], d, qkv3.data_ptr(), p["bias"].data_ptr(),
        p["scale"].data_ptr(), out.data_ptr(), m, n, heads, _build.stream_handle(q.device),
    )
    _build.check(lib, err, f"{what} (bf_axial_flash_fwd)")
    return out


def flash_bwd_cuda(do, q, k, v, bias=None, scale_factor=None) -> tuple:
    """Launch ``csrc/axial_flash.cu``'s backward: the gradients
    :func:`flash_bwd_plain` returns."""
    heads, m, n, d = q.shape
    what = "flash_packed_attention_bwd"
    p = _cuda_args(q, k, v, bias, scale_factor, what)
    _build.check_shapes(what, do=(do, q.shape))
    dev, dt = q.device, q.dtype
    # Held by a name until the launches are queued.
    qkv3, do = torch.stack([q, k, v]).contiguous(), do.to(dt).contiguous()
    dqkv3 = torch.empty(3, heads, m, n, d, device=dev, dtype=dt)
    stats = torch.empty(heads, m, n, 3, device=dev) if n > LINE_TILE else None
    dbias = torch.empty(heads, n, n, device=dev)
    dscale = torch.empty(heads, 2, device=dev)
    part, plan = line_bwd_scratch(1, m, n, heads, d, dev, ln=False, passes=1)
    lib = _build.library()
    err = lib.bf_axial_flash_bwd(
        _build.DTYPE_CODES[dt], d, qkv3.data_ptr(), do.data_ptr(), p["bias"].data_ptr(),
        p["scale"].data_ptr(), dqkv3.data_ptr(), None if stats is None else stats.data_ptr(),
        dbias.data_ptr(), dscale.data_ptr(), part.data_ptr(), *plan[:2], m, n, heads,
        _build.stream_handle(dev),
    )
    _build.check(lib, err, f"{what} (bf_axial_flash_bwd)")
    return (dqkv3[0], dqkv3[1], dqkv3[2], None if bias is None else dbias,
            None if scale_factor is None else dscale[:, 0])


def _flash_fwd(q, k, v, bias, scale_factor):
    if q.device.type == "cpu":
        return flash_plain(q, k, v, bias, scale_factor)
    if q.device.type != "cuda":
        raise ValueError(f"flash_packed_attention: unsupported device {q.device}")
    out = flash_fwd_cuda(q, k, v, bias, scale_factor)
    flash_packed_attention.launches += 1
    return out


def flash_packed_attention_bwd(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: Optional[torch.Tensor] = None,
                               scale_factor: Optional[torch.Tensor] = None) -> tuple:
    """K8's backward: the gradients :func:`flash_bwd_plain` returns.

    CPU tensors take :func:`flash_bwd_plain`; CUDA tensors launch
    ``csrc/axial_flash.cu``'s backward and count
    ``flash_packed_attention_bwd.launches``.  The bias and scale gradients
    are sums over the lines from per-block partials added in a fixed order:
    they repeat bit for bit."""
    if q.device.type == "cpu":
        return flash_bwd_plain(do, q, k, v, bias, scale_factor)
    if q.device.type != "cuda":
        raise ValueError(f"flash_packed_attention_bwd: unsupported device {q.device}")
    grads = flash_bwd_cuda(do, q, k, v, bias, scale_factor)
    flash_packed_attention_bwd.launches += 1
    return grads


def flash_packed_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor] = None, scale_factor: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over the lines of ``q``, ``k``, ``v`` ``(heads, M, n, d)``
    (float32 or bfloat16, promoted to one dtype as the JAX entry does) with
    ``bias`` ``(heads, n, n)`` and ``scale_factor`` ``(heads,)`` (None: s =
    1); returns ``(heads, M, n, d)``, differentiable in every argument.  CPU
    tensors take the plain versions; CUDA tensors launch the kernels
    (``flash_packed_attention.launches`` and
    ``flash_packed_attention_bwd.launches`` count them)."""
    common = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    return LineAttention.apply(_flash_fwd, flash_packed_attention_bwd, {}, q.to(common),
                               k.to(common), v.to(common), bias, scale_factor)


flash_packed_attention.launches = 0
flash_packed_attention_bwd.launches = 0
