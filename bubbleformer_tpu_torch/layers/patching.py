"""Hierarchical patch embedding / de-embedding (channels-last).

Counterpart of ``bubbleformer_tpu/layers/patching.py`` in its s2d/d2s matmul
form (``:27-97``): each of the ``log2(patch)`` stages is a k2/s2 convolution
computed as space-to-depth plus one matmul (embed) or one matmul plus
depth-to-space (debed), with ``E/4`` intermediate width and InstanceNorm +
exact GELU between stages.

The ``in_proj`` / ``out_proj`` Sequentials hold ``Conv2d`` /
``ConvTranspose2d`` modules only as weight containers, so the keys are the
reference's (``embed.in_proj.{3i}.weight`` ``(O, I, 2, 2)``,
``debed.out_proj.{3i}.weight`` ``(I, O, 2, 2)``, norms at ``3i+1``).  Both
kinds of stage are ``(2, 2, I, O)`` kernels in the JAX package, drawn from
``lecun_normal`` over a fan-in of ``4 I`` (``layers/init.py``), the
transposed ones too: torch's own fan-in of a ``ConvTranspose2d`` would be
``4 O``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bubbleformer_tpu_torch.layers.init import lecun_normal_
from bubbleformer_tpu_torch.layers.norm import InstanceNorm


def _num_stages(patch_size: int) -> int:
    num_layers = int(math.log2(patch_size))
    if 2**num_layers != patch_size:
        raise ValueError("Patch size must be a power of 2")
    return num_layers


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, C) -> (B, H/2, W/2, 4C)`` with ``(dy, dx, c)`` minor order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


class HMLPEmbed(nn.Module):
    """``(B, H, W, C_in) -> (B, H/p, W/p, E)``; ``prefolded=True`` takes the
    first stage's space-to-depth fold already done ``(B, H/2, W/2, 4 C_in)``."""

    def __init__(self, patch_size: int = 16, in_channels: int = 3, embed_dim: int = 768,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        n = _num_stages(patch_size)
        layers = []
        cin = in_channels
        for i in range(n):
            is_last = i == n - 1
            out_ch = embed_dim if (is_last or n == 1) else embed_dim // 4
            conv = nn.Conv2d(cin, out_ch, 2, 2, bias=False)
            lecun_normal_(conv.weight, 4 * cin)  # the flax kernel (2, 2, cin, out_ch)
            layers += [conv, InstanceNorm(out_ch)]
            if not is_last:
                layers.append(nn.GELU())
            cin = out_ch
        self.in_proj = nn.Sequential(*layers)
        self.num_stages = n
        self.dtype = dtype

    def forward(self, x: torch.Tensor, prefolded: bool = False) -> torch.Tensor:
        for i in range(self.num_stages):
            conv, norm = self.in_proj[3 * i], self.in_proj[3 * i + 1]
            if not (i == 0 and prefolded):
                x = space_to_depth(x)
            # (O, I, dy, dx) -> (dy, dx, I) x O, the fold's minor order.
            k = conv.weight.permute(2, 3, 1, 0).reshape(-1, conv.weight.shape[0])
            dt = self.dtype or x.dtype
            x = torch.matmul(x.to(dt), k.to(dt))
            x = norm(x)
            if i < self.num_stages - 1:
                x = F.gelu(x, approximate="none")
        return x


class HMLPDebed(nn.Module):
    """``(B, H/p, W/p, E) -> (B, C_out, H, W)`` (channels-first output, the
    last depth-to-space shuffle folded into the NCHW relayout), or ``(B, H,
    W, C_out)`` with ``emit_nchw=False`` (the pyramid's own channels-last
    layout, ``bubbleformer_tpu/layers/patching.py`` ``emit_nchw``)."""

    def __init__(self, patch_size: int = 16, out_channels: int = 3, embed_dim: int = 768,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        n = _num_stages(patch_size)
        layers = []
        cin = embed_dim
        for i in range(n):
            is_last = i == n - 1
            out_ch = out_channels if (is_last or n == 1) else embed_dim // 4
            deconv = nn.ConvTranspose2d(cin, out_ch, 2, 2, bias=False)
            lecun_normal_(deconv.weight, 4 * cin)  # the flax kernel (2, 2, cin, out_ch)
            layers.append(deconv)
            if not is_last:
                layers += [InstanceNorm(out_ch), nn.GELU()]
            cin = out_ch
        self.out_proj = nn.Sequential(*layers)
        self.num_stages = n
        self.dtype = dtype

    def forward(self, x: torch.Tensor, emit_nchw: bool = True) -> torch.Tensor:
        for i in range(self.num_stages):
            w = self.out_proj[3 * i].weight  # (I, O, dy, dx)
            cin, cout = w.shape[0], w.shape[1]
            k = w.permute(0, 2, 3, 1).reshape(cin, 4 * cout)
            dt = self.dtype or x.dtype
            y = torch.matmul(x.to(dt), k.to(dt))  # (b, h, w, (dy, dx, out))
            b, h, ww = y.shape[:3]
            y = y.reshape(b, h, ww, 2, 2, cout)
            if i == self.num_stages - 1 and emit_nchw:
                return y.permute(0, 5, 1, 3, 2, 4).reshape(b, cout, 2 * h, 2 * ww)
            x = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * ww, cout)
            if i == self.num_stages - 1:
                return x
            x = F.gelu(self.out_proj[3 * i + 1](x), approximate="none")
        return x
