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
tensors its forward and backward launch hand-written kernels, chosen by
dtype in one place (:func:`flash_kernels`): bfloat16 runs the Hopper kernels
of ``csrc/flash_hopper.cuh`` (C entries ``csrc/axial_flash_hopper.cu``:
rows staged in bf16, every product on the tensor cores with ``P_eff`` and
``dS`` split into bf16 pairs, lines of at most 16 tokens packed into 16-row
tiles; :func:`flash_hopper_fwd`, :func:`flash_hopper_bwd`, the blocks'
segments planned by :func:`flash_bwd_plan`); float32 runs the line kernels
of ``csrc/axial_flash.cu`` in their kFlash flavour (:func:`flash_line_fwd`,
:func:`flash_line_bwd`), and so does a bfloat16 backward whose lines the
Hopper backward does not stage (head dim 64, more than 256 tokens).  Both
take head dims 16 and 64 and lines of up to 512 tokens; any other shape
raises.  The bias and scale gradients are sums over the lines in a fixed
order (a first level inside the launch, ``csrc/param_sums.cuh``): they
repeat bit for bit.  On CPU tensors :func:`flash_plain` and
:func:`flash_bwd_plain`; on any other device they raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.layers.norm import accumulation_dtype
from bubbleformer_tpu_torch.ops.axial_lane import (
    HEAD_DIMS,
    LINE_TILE,
    MAX_LINE,
    LineAttention,
    lane_bwd_plan,
    line_bwd_scratch,
)

# The Hopper backward stages four (rows, d) bf16 tiles of a segment and takes
# the lines whose tiles fit in this many bytes (csrc/flash_hopper.cuh:
# kBwdStageBytes): every line at head dim 16, up to 256 tokens at 64.
FLASH_BWD_STAGE_BYTES = 128 << 10


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


def flash_geometry(n: int) -> dict:
    """How the bf16 Hopper kernels stage lines of ``n`` tokens
    (``csrc/flash_hopper.cuh: Geo``): units of ``ru`` rows (a key chunk of 32
    or more), ``units`` of them a block; ``n <= 16`` puts ``lp16 = 16 // n``
    lines in each 16-row tile, two tiles a unit; longer lines a line a unit;
    a segment is the ``lps`` lines a block stages at once, ``rows`` rows."""
    lp16 = 16 // n if n <= 16 else 0
    ru = 32 if n <= 16 else -(-n // 32) * 32
    units = 1 if ru >= 128 else 128 // ru
    lpu = 2 * lp16 if n <= 16 else 1
    return dict(lp16=lp16, ru=ru, units=units, lps=units * lpu, rows=units * ru)


def flash_rows(m: int, n: int, seg: int) -> list:
    """``(line, position)`` of each staged row of segment ``seg`` of M lines
    of ``n`` tokens (None: an empty row), as ``Geo::line_of`` and
    ``seg_rows`` place them."""
    g = flash_geometry(n)
    out = []
    for r in range(g["rows"]):
        u, rr = divmod(r, g["ru"])
        if g["lp16"]:
            a, pos = divmod(rr % 16, n)
            li = None if a >= g["lp16"] else u * 2 * g["lp16"] + rr // 16 * g["lp16"] + a
        else:
            li, pos = (u, rr) if rr < n else (None, 0)
        line = None if li is None else seg * g["lps"] + li
        out.append(None if line is None or line >= m else (line, pos))
    return out


def flash_hopper_bwd_fits(n: int, d: int) -> bool:
    """Whether the Hopper backward stages lines of ``n`` tokens at head dim
    ``d`` (its four bf16 tiles within ``FLASH_BWD_STAGE_BYTES``)."""
    return 1 <= n <= MAX_LINE and 8 * (-(-n // 32) * 32) * d <= FLASH_BWD_STAGE_BYTES


def flash_bwd_plan(m: int, n: int, heads: int, resident: int) -> tuple:
    """``(floats, groups, per)`` of the bf16 Hopper backward: block ``g`` of
    a head owns the segments ``g * per`` to ``(g + 1) * per`` of the M lines
    (:func:`flash_geometry`; :func:`lane_bwd_plan` over one wave of the
    ``resident`` blocks) and sums the table's and the scale's gradients over
    them into one partial; ``floats`` is the size of the float32 buffer of
    the partials, the tables ``(groups, heads, n, n)`` then the scales
    ``(heads, groups)``."""
    segments = -(-m // flash_geometry(n)["lps"])
    groups, per = lane_bwd_plan(segments, heads, resident)
    return groups * heads * (n * n + 1), groups, per


@functools.lru_cache(maxsize=None)
def _flash_resident(index: int, head_dim: int, n: int) -> int:
    """Blocks of the Hopper backward for lines of ``n`` tokens that card
    ``index`` holds at once (C entry ``bf_flash_hopper_resident``)."""
    lib = _build.library()
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.bf_flash_hopper_resident(head_dim, n, ctypes.byref(per_sm))
    _build.check(lib, err, "bf_flash_hopper_resident")
    return torch.cuda.get_device_properties(index).multi_processor_count * max(1, per_sm.value)


def flash_hopper_fwd(q, k, v, bias=None, scale_factor=None) -> torch.Tensor:
    """K8's bf16 forward on the Hopper kernels (``csrc/flash_hopper.cuh``, C
    entry ``bf_flash_hopper_fwd``); counts ``flash_hopper_fwd.launches``."""
    heads, m, n, d = q.shape
    what = "flash_packed_attention (bf_flash_hopper_fwd)"
    p = _cuda_args(q, k, v, bias, scale_factor, what)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    _build.check_tma(what, q=q, k=k, v=v, out=out)
    lib = _build.library()
    err = lib.bf_flash_hopper_fwd(d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  p["bias"].data_ptr(), p["scale"].data_ptr(), out.data_ptr(), m,
                                  n, heads, _build.stream_handle(q.device))
    _build.check(lib, err, what)
    flash_hopper_fwd.launches += 1
    return out


def flash_hopper_bwd(do, q, k, v, bias=None, scale_factor=None) -> tuple:
    """K8's bf16 backward on the Hopper kernels (C entry
    ``bf_flash_hopper_bwd``): one launch, then one that adds the blocks'
    partials (:func:`flash_bwd_plan`) in a fixed order.  The gradients
    :func:`flash_bwd_plain` returns; counts ``flash_hopper_bwd.launches``."""
    heads, m, n, d = q.shape
    what = "flash_packed_attention_bwd (bf_flash_hopper_bwd)"
    p = _cuda_args(q, k, v, bias, scale_factor, what)
    _build.check_shapes(what, do=(do, q.shape))
    dev, dt = q.device, q.dtype
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.to(dt).contiguous()
    dqkv3 = torch.empty(3, heads, m, n, d, device=dev, dtype=dt)
    _build.check_tma(what, q=q, k=k, v=v, do=do, dqkv3=dqkv3)
    floats, groups, per = flash_bwd_plan(m, n, heads, _flash_resident(dev.index, d, n))
    part = torch.empty(floats, device=dev)
    dbias = torch.empty(heads, n, n, device=dev)
    dscale = torch.empty(heads, 2, device=dev)
    lib = _build.library()
    err = lib.bf_flash_hopper_bwd(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), p["bias"].data_ptr(),
        p["scale"].data_ptr(), dqkv3[0].data_ptr(), dqkv3[1].data_ptr(), dqkv3[2].data_ptr(),
        part.data_ptr(), dbias.data_ptr(), dscale.data_ptr(), groups, per, m, n, heads,
        _build.stream_handle(dev))
    _build.check(lib, err, what)
    flash_hopper_bwd.launches += 1
    return (dqkv3[0], dqkv3[1], dqkv3[2], None if bias is None else dbias,
            None if scale_factor is None else dscale[:, 0])


def flash_line_fwd(q, k, v, bias=None, scale_factor=None) -> torch.Tensor:
    """K8's forward on the line kernels (``csrc/axial_flash.cu``, kFlash),
    float32; counts ``flash_line_fwd.launches``."""
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
    flash_line_fwd.launches += 1
    return out


def flash_line_bwd(do, q, k, v, bias=None, scale_factor=None) -> tuple:
    """K8's backward on the line kernels (``csrc/axial_flash.cu``, kFlash):
    float32, and bfloat16 lines the Hopper backward does not stage; the
    gradients :func:`flash_bwd_plain` returns; counts
    ``flash_line_bwd.launches``."""
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
    flash_line_bwd.launches += 1
    return (dqkv3[0], dqkv3[1], dqkv3[2], None if bias is None else dbias,
            None if scale_factor is None else dscale[:, 0])


flash_hopper_fwd.launches = flash_hopper_bwd.launches = 0
flash_line_fwd.launches = flash_line_bwd.launches = 0


def flash_kernels(dtype: torch.dtype, n: int = 1, d: int = 64) -> tuple:
    """K8's ``(forward, backward)`` kernels on the card for ``dtype`` and
    lines of ``n`` tokens at head dim ``d``: the Hopper kernels for bfloat16
    (its backward while :func:`flash_hopper_bwd_fits`, else the line
    kernels'), the line kernels for float32; any other dtype raises."""
    if dtype == torch.bfloat16:
        return flash_hopper_fwd, (flash_hopper_bwd if flash_hopper_bwd_fits(n, d)
                                  else flash_line_bwd)
    if dtype == torch.float32:
        return flash_line_fwd, flash_line_bwd
    raise TypeError(f"flash_packed_attention kernel takes float32 or bfloat16, not {dtype}")


def _flash_fwd(q, k, v, bias, scale_factor):
    if q.device.type == "cpu":
        return flash_plain(q, k, v, bias, scale_factor)
    if q.device.type != "cuda":
        raise ValueError(f"flash_packed_attention: unsupported device {q.device}")
    out = flash_kernels(q.dtype)[0](q, k, v, bias, scale_factor)
    flash_packed_attention.launches += 1
    return out


def flash_packed_attention_bwd(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: Optional[torch.Tensor] = None,
                               scale_factor: Optional[torch.Tensor] = None) -> tuple:
    """K8's backward: the gradients :func:`flash_bwd_plain` returns.

    CPU tensors take :func:`flash_bwd_plain`; CUDA tensors the kernels
    :func:`flash_kernels` picks (bfloat16 :func:`flash_hopper_bwd`, float32
    :func:`flash_line_bwd`) and count ``flash_packed_attention_bwd.launches``.
    The bias and scale gradients are sums over the lines from partials added
    in a fixed order: they repeat bit for bit."""
    if q.device.type == "cpu":
        return flash_bwd_plain(do, q, k, v, bias, scale_factor)
    if q.device.type != "cuda":
        raise ValueError(f"flash_packed_attention_bwd: unsupported device {q.device}")
    grads = flash_kernels(q.dtype, q.shape[2], q.shape[3])[1](do, q, k, v, bias, scale_factor)
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
