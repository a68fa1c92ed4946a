"""Plain attention math shared by the plain versions of both kernels.

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

In float32 both are the same function.  The plain versions accumulate in
float32, or in float64 for float64 inputs (:func:`accumulation_dtype`), so
that the tests can hold their gradients against float64 autograd.
"""
from __future__ import annotations

from typing import Optional

import torch

from bubbleformer_tpu_torch.layers.norm import accumulation_dtype


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

