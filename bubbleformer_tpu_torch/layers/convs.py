"""Convolutional building blocks of the U-Net baselines (channels-first).

Counterpart of ``bubbleformer_tpu/layers/convs.py``: ``ResidualBlock``
(``:13``), ``MiddleBlock`` (``:46``), ``ClassicUnetBlock`` (``:60``),
``Upsample`` (``:85``) and ``Downsample`` (``:109``), on ``(B, C, H, W)``.
Submodules carry the JAX modules' names, so the weight bridge
(``utils/convert.py:unet_params_to_state_dict``) is a mechanical map.

Rounding points follow the JAX modules' under a ``dtype`` (bfloat16):

* every convolution casts its input and weight to ``dtype``, convolves,
  then adds the bias rounded to ``dtype`` (flax's ``Conv`` and
  ``ConvTranspose``): its output is ``dtype``;
* :class:`GroupNorm` and :class:`BatchNorm` compute their statistics and
  their output in float32 whatever the input dtype (flax promotes the input
  against the float32 scale when the norm's ``dtype`` is None; a float64
  model, as a test's reference, stays float64); the exact
  GELU after them stays float32 and the next convolution rounds it.

So a ``ResidualBlock`` returns ``dtype`` and a ``ClassicUnetBlock`` float32.
Both norms compute their statistics in float32 through torch's own
normalisation (``F.group_norm``, ``F.batch_norm``: one kernel forward, one
backward, the input and the statistics saved); flax takes the one-pass
variance ``E[x^2] - E[x]^2`` (``use_fast_variance=True``), so the two agree
to rounding except where that one-pass form cancels (a mean far above the
spread), where flax's is the less accurate.

:class:`BatchNorm` keeps flax's running statistics
(``flax/linen/normalization.py:402-404``): in train mode it normalises with
the batch's statistics and updates ``running_mean``/``running_var`` as
``(1 - momentum) * running + momentum * batch`` with the **biased** batch
variance (torch's ``BatchNorm2d`` takes the unbiased one); flax's
``momentum=0.9`` is torch's ``momentum=0.1``.  In eval mode it normalises
with the running statistics, which start at mean 0 and variance 1.
``module.train()`` / ``module.eval()`` select the mode, as ``train=`` with
``mutable=["batch_stats"]`` does in the JAX training module.  Under data
parallelism (``batch_shard`` set by the training module to ``(rank,
world)``) a train-mode BatchNorm normalises with the statistics of the
global batch, as flax's batch mean over the JAX package's global arrays
does: each channel's count and sum, then its second moment about the global
mean, are summed over the ranks by an autograd-aware all-reduce
(``parallel/mesh.py:all_reduce_sum``, whose backward sums the gradients the
same way), and the running update takes the global biased
variance, so every rank keeps the same statistics (``nn.SyncBatchNorm``
would update them with the unbiased one).

The convolutions draw their weights as flax's ``Conv`` and ``ConvTranspose``
do (``layers/init.py``): ``lecun_normal`` over the flax kernel's fan-in and
zero biases.  flax's ``Conv`` kernel is ``(kh, kw, in, out)``, a fan-in of
``kh kw in``; the JAX U-Nets' ``ConvTranspose(transpose_kernel=True)``
kernel is ``(kh, kw, out, in)``, a fan-in of ``kh kw out``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bubbleformer_tpu_torch.layers.init import lecun_normal_, zeros_

__all__ = ["Conv2d", "ConvTranspose2d", "GroupNorm", "BatchNorm", "ResidualBlock",
           "MiddleBlock", "ClassicUnetBlock", "Upsample", "Downsample"]


def _compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor,
                   weight: torch.Tensor) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, weight.dtype)


def _at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in float64 where it is (a float64 reference)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return y if bias is None else y + bias.to(y.dtype)[:, None, None]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` (None: the promoted dtype of
    input and weight), the bias added after the convolution's rounding."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        kh, kw = self.kernel_size
        lecun_normal_(self.weight, kh * kw * self.in_channels)  # flax (kh, kw, in, out)
        zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.compute_dtype, x, self.weight)
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)
        return _add_bias(y, self.bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (weight ``(I, O, kh, kw)``) computing in
    ``dtype``, as :class:`Conv2d`; flax's ``ConvTranspose(transpose_kernel=
    True)`` with ``'SAME'`` at k4 s2 is this at padding 1, ``'VALID'`` at
    k2 s2 at padding 0."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        kh, kw = self.kernel_size
        # flax's transpose_kernel=True kernel (kh, kw, out, in)
        lecun_normal_(self.weight, kh * kw * self.out_channels)
        zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        dt = _compute_dtype(self.compute_dtype, x, self.weight)
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)
        return _add_bias(y, self.bias)


class GroupNorm(nn.Module):
    """GroupNorm over ``(C / groups, H, W)`` of each sample, float32 out."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(_at_least_float32(x), self.num_groups, self.weight, self.bias, self.eps)


class BatchNorm(nn.Module):
    """BatchNorm over ``(B, H, W)`` with flax's running statistics, float32
    out (module docstring)."""

    def __init__(self, num_channels: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.register_buffer("running_mean", torch.zeros(num_channels))
        self.register_buffer("running_var", torch.ones(num_channels))
        self.batch_shard = (0, 1)  # (rank, world) of a data-parallel run

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the global batch of ``batch_shard[1]`` ranks."""
        from bubbleformer_tpu_torch.parallel.mesh import all_reduce_sum

        dims = (0, 2, 3)
        count = torch.tensor([float(x.numel() // x.shape[1])], device=x.device)
        sums = all_reduce_sum(torch.cat([count, x.sum(dim=dims)]))
        mean = sums[1:] / sums[0]
        centred = x - mean[:, None, None]
        var = all_reduce_sum((centred * centred).sum(dim=dims)) / sums[0]
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return centred * scale[:, None, None] + self.bias[:, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = _at_least_float32(x)
        if self.training and self.batch_shard[1] > 1:
            return self._global_batch_norm(xf)
        if self.training:
            with torch.no_grad():
                var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
        return F.batch_norm(xf, None if self.training else self.running_mean,
                            None if self.training else self.running_var, self.weight,
                            self.bias, training=self.training, eps=self.eps)


class ResidualBlock(nn.Module):
    """Wide-ResNet block: (GroupNorm -> GELU -> Conv3x3) x2 + shortcut (a
    1x1 conv where the channel count changes)."""

    def __init__(self, in_channels: int, out_channels: int, norm: bool = True,
                 n_groups: int = 8, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm1 = GroupNorm(n_groups, in_channels) if norm else nn.Identity()
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNorm(n_groups, out_channels) if norm else nn.Identity()
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.shortcut = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                         if in_channels != out_channels else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.gelu(self.norm1(x), approximate="none"))
        h = self.conv2(F.gelu(self.norm2(h), approximate="none"))
        return h + self.shortcut(x)


class MiddleBlock(nn.Module):
    """Two ResidualBlocks at the bottleneck."""

    def __init__(self, channels: int, norm: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.res1 = ResidualBlock(channels, channels, norm=norm, dtype=dtype)
        self.res2 = ResidualBlock(channels, channels, norm=norm, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.res2(self.res1(x))


class ClassicUnetBlock(nn.Module):
    """(Conv3x3 without bias -> BatchNorm -> GELU) x2."""

    def __init__(self, in_channels: int, out_channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, bias=False, dtype=dtype)
        self.norm1 = BatchNorm(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, bias=False, dtype=dtype)
        self.norm2 = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.norm1(self.conv1(x)), approximate="none")
        return F.gelu(self.norm2(self.conv2(x)), approximate="none")


class Upsample(nn.Module):
    """2x spatial upsample: ConvTranspose k4 s2 p1."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = ConvTranspose2d(channels, channels, 4, stride=2, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Downsample(nn.Module):
    """2x spatial downsample: Conv k3 s2 p1."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
