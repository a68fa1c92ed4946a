"""Plain attention math: the plain versions of the kernels and the XLA routes.

Counterpart of ``bubbleformer_tpu/ops/attention.py``.  The reference's
attn_scale decomposition (uniform low-frequency part plus a learned scale of
the high-frequency rest) collapses algebraically to

    out = s * softmax(q k^T / sqrt(d) + bias) @ v + (1 - s) * mean_k(v)

(``ops/attention.py:14-17``).  The two TPU kernels round it at different
points, and the plain versions must round where their kernel does:

* the temporal megakernel blends after the value product, in float32
  (``temporal_block_mega.py:_attention_fwd``): ``fold_dtype=None``;
* the lane axial kernel folds the blend into the probabilities, rounds them
  to the activation dtype and then multiplies by ``v``
  (``axial_lane.py:_axis_fwd``): ``fold_dtype=<activation dtype>``.

In float32 both are the same function, and so are the JAX package's XLA
routes (:func:`xla_axis_attention`, :func:`packed_attention`), which round
where XLA rounds.  The plain versions accumulate in float32, or in float64
for float64 inputs (:func:`accumulation_dtype`), so that the tests can hold
their gradients against float64 autograd.
"""
from __future__ import annotations

from typing import Optional

import torch

from bubbleformer_tpu_torch.layers.norm import accumulation_dtype


# The axial layouts: per-head tokens (bt, h, w, heads, d) as lines of a
# sequence axis for the attention functions below.
def to_rows(a: torch.Tensor) -> torch.Tensor:
    """(bt, h, w, heads, d) <-> (bt, h, heads, w, d): its own inverse."""
    return a.permute(0, 1, 3, 2, 4)


def to_cols(a: torch.Tensor) -> torch.Tensor:
    """(bt, h, w, heads, d) -> (bt, w, heads, h, d)."""
    return a.permute(0, 2, 3, 1, 4)


def from_cols(a: torch.Tensor) -> torch.Tensor:
    """(bt, w, heads, h, d) -> (bt, h, w, heads, d): the inverse of :func:`to_cols`."""
    return a.permute(0, 3, 1, 2, 4)


def axis_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor], scale: Optional[torch.Tensor],
                   fold_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Attention over the sequence axis of ``(batch..., heads, L, d)`` tensors.

    ``bias``: ``(heads, L, L)`` or None; ``scale``: ``(heads,)`` or None.
    Logits, softmax and the value product accumulate in float32 (float64 for
    float64 inputs); the result is in that dtype ``(batch..., heads, L, d)``.
    """
    heads, seq, d = q.shape[-3], q.shape[-2], q.shape[-1]
    acc = accumulation_dtype(q.dtype)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * d**-0.5
    if bias is not None:
        logits = logits + bias.to(acc)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    z = e.sum(dim=-1, keepdim=True)
    s = (torch.ones(heads, device=q.device, dtype=acc) if scale is None else scale.to(acc))
    s = s.reshape(heads, 1, 1)
    vf = v.to(acc)
    if fold_dtype is not None:
        # lane kernel: jax.nn.softmax divides by the sum.
        pb = (s * (e / z) + (1.0 - s) * (1.0 / seq)).to(fold_dtype).to(acc)
        return torch.matmul(pb, vf)
    # temporal megakernel: multiplies by the reciprocal of the sum.
    p = e * (1.0 / z)
    return s * torch.matmul(p, vf) + (1.0 - s) * vf.mean(dim=-2, keepdim=True)



def xla_axis_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: Optional[torch.Tensor], scale: Optional[torch.Tensor],
                       unrolled: bool = False) -> torch.Tensor:
    """Attention over the sequence axis of ``(batch..., heads, L, d)`` tensors
    in the activation dtype, rounding where the JAX package's XLA routes
    round: ``axis_attention`` (``bubbleformer_tpu/ops/attention.py:191``, the
    ``plain`` route) with ``unrolled=False``, ``unrolled_axis_attention``
    (``:140``, the ``unrolled`` route) with ``unrolled=True``.

    Both take float32 logits and softmax and round the probabilities to
    ``v.dtype``; ``plain`` accumulates their product with ``v`` in float32
    and rounds it once, ``unrolled`` rounds each product ``dtype(P_ij) *
    v_j`` before the float32 sum.  The attn_scale blend ``s * out + (1 - s)
    * mean(v)`` then runs in ``v.dtype`` (the mean accumulated in float32).
    These are XLA in the JAX package, not Pallas kernels: plain PyTorch is
    their port on every device.  Returns ``(batch..., heads, L, d)`` in
    ``v.dtype``.
    """
    heads, d = q.shape[-3], q.shape[-1]
    dt, acc = v.dtype, accumulation_dtype(v.dtype)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * d**-0.5
    if bias is not None:
        logits = logits + bias.to(acc)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    if unrolled:
        out = (p.unsqueeze(-1) * v.unsqueeze(-3)).to(acc).sum(dim=-2).to(dt)
    else:
        out = torch.matmul(p.to(acc), v.to(acc)).to(dt)
    if scale is None:
        return out
    s = scale.reshape(heads, 1, 1)
    v_mean = v.to(acc).mean(dim=-2, keepdim=True).to(dt)
    # unrolled: 1 - s after the cast (``:185-187``); plain: before (``:249``).
    one_minus = 1.0 - s.to(dt) if unrolled else (1.0 - s).to(dt)
    return s.to(dt) * out + one_minus * v_mean


def pick_group_size(num_elements: int, seq_len: int, target: int = 256) -> int:
    """The XLA ``packed`` route's packing group: the largest G with G*n <=
    target that divides the number of lines (``bubbleformer_tpu/ops/
    attention.py:62``)."""
    g = max(1, target // seq_len)
    while g > 1 and num_elements % g:
        g -= 1
    return g


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     scale_factor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's XLA ``packed`` route (``bubbleformer_tpu/ops/
    attention.py:76 packed_attention``): ``q``, ``k``, ``v`` ``(heads, M,
    n, d)``, ``bias`` ``(heads, n, n)``, ``scale_factor`` ``(heads,)``;
    returns ``(heads, M, n, d)`` in ``v.dtype``.

    JAX packs :func:`pick_group_size` lines into one super-line with a
    block-diagonal -1e9 mask; ``exp(-1e9)`` underflows to exactly 0 in
    float32, so each row is its own line's softmax and the masked products
    add exact zeros: per-line attention, which is what this computes, for
    ``G > 1`` and for the ``G <= 1`` branch through ``scaled_axial_attention``
    alike.  It rounds where both branches round: float32 logits and softmax,
    the probabilities rounded to ``v.dtype``, their product with ``v``
    accumulated in float32 and rounded (:func:`xla_axis_attention`), then
    the blend ``s * out + (1 - s) * mean(v)`` in ``v.dtype`` with ``1 - s``
    taken after the cast (``:106-108``, ``:134-136``).  In bfloat16 this is
    neither the ``plain`` route (``1 - s`` before the cast) nor K8 (float32
    throughout, rounded once)."""
    heads = q.shape[0]
    dt, acc = v.dtype, accumulation_dtype(v.dtype)

    def lines(a):  # (heads, M, n, d) -> (M, heads, n, d), a view
        return a.transpose(0, 1)

    out = xla_axis_attention(lines(q), lines(k), lines(v), bias, None).transpose(0, 1)
    if scale_factor is None:
        return out
    s = scale_factor.reshape(heads, 1, 1, 1).to(dt)
    v_mean = v.to(acc).mean(dim=-2, keepdim=True).to(dt)
    return s * out + (1.0 - s) * v_mean


def qk_layer_norm(q: torch.Tensor, k: torch.Tensor, qnorm, knorm):
    """The XLA routes' qk-LayerNorm (``bubbleformer_tpu/layers/
    attention.py:284-285, 477-478``): float32 statistics and affine, cast
    back to the activation dtype."""
    return qnorm(q).to(q.dtype), knorm(k).to(k.dtype)
