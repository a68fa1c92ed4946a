"""flax's default initialisers, for the port's layers.

flax's ``Dense``, ``Conv`` and ``ConvTranspose``, and the kernels the JAX
package declares by hand (``bubbleformer_tpu/layers/patching.py:51,80``,
``layers/norm.py:DenseParams``), draw their kernels from
``nn.initializers.lecun_normal()`` and their biases as zeros.  torch's
``nn.Linear`` and ``nn.Conv2d`` draw kaiming-uniform weights and non-zero
uniform biases instead, so every layer of the port that declares a weight
draws it again here, in its constructor, from the same distribution as its
flax counterpart.

``lecun_normal`` is ``variance_scaling(1.0, "fan_in", "truncated_normal")``:
a normal of standard deviation ``sqrt(1 / fan_in) / 0.8796...`` truncated at
two of those deviations, so that the truncated draw has variance
``1 / fan_in``.  ``fan_in`` is the product of the flax kernel's dims other
than its last two, times its second-to-last: each caller computes it from
the flax kernel's shape, which torch's layout does not always give (a torch
``ConvTranspose2d`` weight is ``(in, out, kh, kw)`` whatever the flax kernel
is).  The draws come from torch's generator, so they differ from JAX's for
the same seed; the distributions are the same.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

# The standard deviation of a unit normal truncated to (-2, 2) (flax's
# ``variance_scaling`` divides by it).
TRUNCATED_STD = 0.87962566103423978


def lecun_std(fan_in: int) -> float:
    """The deviation of the normal that ``lecun_normal`` truncates at two of
    it (its truncated draw has deviation ``fan_in ** -0.5``)."""
    return (1.0 / fan_in) ** 0.5 / TRUNCATED_STD


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """Fill ``weight`` in place as flax's ``lecun_normal()`` draws a kernel of
    fan-in ``fan_in``: unit normals, those beyond two drawn again until none
    is (the truncated normal, by rejection: as fast as one ``normal_``, where
    ``nn.init.trunc_normal_``'s inverse CDF takes ten times longer, which a
    566M-parameter U-Net feels), then scaled.  A tensor on the meta device
    holds no values and is left as it is."""
    if weight.is_meta:
        return weight
    flat = weight.view(-1)
    flat.normal_()
    redo = (flat.abs() > 2.0).nonzero().squeeze(1)
    while redo.numel():
        draw = torch.randn(redo.numel(), dtype=flat.dtype, device=flat.device)
        flat[redo] = draw
        redo = redo[draw.abs() > 2.0]
    return weight.mul_(lecun_std(fan_in))


@torch.no_grad()
def zeros_(bias: Optional[torch.Tensor]) -> None:
    """Zero ``bias`` in place (flax's bias init); nothing for None."""
    if bias is not None:
        bias.zero_()


def dense_(layer: nn.Module) -> nn.Module:
    """Initialise an ``nn.Linear``, or an ``nn.Conv2d`` with 1x1 kernels, as
    flax's ``Dense`` of the same width: the flax kernel is ``(in, out)``, so
    its fan-in is the torch weight's second dim.  Returns ``layer``."""
    lecun_normal_(layer.weight, layer.weight.shape[1])
    zeros_(layer.bias)
    return layer
