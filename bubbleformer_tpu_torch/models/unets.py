"""U-Net baselines: ModernUnet (wide-ResNet, GroupNorm) and ClassicUnet
(Ronneberger 2015, BatchNorm).

Counterpart of ``bubbleformer_tpu/models/unets.py`` (``ModernUnet :43``,
``ClassicUnet :115``).  Time is folded into channels time-major,
``(B, T, C, H, W) -> (B, T*C, H, W)``, and unfolded at the output; the
public layout is the AViTs' ``(B, T, C, H, W)``.  Skips concatenate as
``[x, skip]`` on channels, in the JAX models' order, and submodules carry
their names (``image_proj``, ``down{i}``, ``middle``, ``up{i}``,
``final_norm``, ``final``; ``encoder1..4``, ``bottleneck``, ``upconv1..4``,
``decoder1..4``).  ``dtype`` (e.g. bfloat16) sets the convolutions' compute
dtype while parameters stay float32, with the JAX models' rounding points
(``layers/convs.py``): ModernUnet's output is ``dtype``, and so is
ClassicUnet's, whose skips concatenate a ``dtype`` upconv with a float32
encoder output and so run the decoders' inputs in float32.

``ch_mults`` compound, as in the JAX model: hidden 32 with ``(1, 2, 2, 4,
4)`` gives widths 32, 32, 64, 128, 512 and 2048.  H and W must be multiples
of 2 ** (levels - 1) (ModernUnet) or 16 (ClassicUnet's four pools).
ClassicUnet's BatchNorms normalise with the batch's statistics in train
mode (``model.train()``) and update their running statistics; in eval mode
they use the running ones.  ``forward`` takes and ignores the drop-path
``generator`` the training module passes every model.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bubbleformer_tpu_torch.layers.convs import (
    ClassicUnetBlock,
    Conv2d,
    ConvTranspose2d,
    Downsample,
    GroupNorm,
    MiddleBlock,
    ResidualBlock,
    Upsample,
)
from bubbleformer_tpu_torch.models._api import register_model

__all__ = ["ModernUnet", "ClassicUnet"]


def _fold_time(x: torch.Tensor) -> torch.Tensor:
    """``(B, T, C, H, W) -> (B, T*C, H, W)``."""
    b, t, c, h, w = x.shape
    return x.reshape(b, t * c, h, w)


def _unfold_time(x: torch.Tensor, time_window: int) -> torch.Tensor:
    """``(B, T*C, H, W) -> (B, T, C, H, W)``."""
    b, tc, h, w = x.shape
    return x.reshape(b, time_window, tc // time_window, h, w)


@register_model("unet_modern")
class ModernUnet(nn.Module):
    """Two ResidualBlocks per resolution on the way down (a Downsample
    between resolutions), a MiddleBlock, then three ResidualBlocks per
    resolution on the way up, each taking a skip (an Upsample between)."""

    def __init__(self, time_window: int = 5, input_fields: int = 4, output_fields: int = 4,
                 hidden_channels: int = 32, ch_mults: Sequence[int] = (), norm: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.time_window = time_window
        hc = hidden_channels
        self.image_proj = Conv2d(input_fields * time_window, hc, 1, dtype=dtype)
        n = len(ch_mults)
        skip_ch = [hc]
        in_ch, idx = hc, 0
        for i in range(n):
            out_ch = in_ch * ch_mults[i]
            for _ in range(2):
                self.add_module(f"down{idx}", ResidualBlock(in_ch, out_ch, norm=norm, dtype=dtype))
                in_ch = out_ch
                skip_ch.append(in_ch)
                idx += 1
            if i < n - 1:
                self.add_module(f"down{idx}", Downsample(in_ch, dtype=dtype))
                skip_ch.append(in_ch)
                idx += 1
        self.num_down = idx
        self.middle = MiddleBlock(in_ch, norm=norm, dtype=dtype)
        idx = 0
        for i in reversed(range(n)):
            out_ch = in_ch
            for _ in range(2):
                self.add_module(f"up{idx}", ResidualBlock(in_ch + skip_ch.pop(), out_ch,
                                                          norm=norm, dtype=dtype))
                idx += 1
            out_ch = in_ch // ch_mults[i]
            self.add_module(f"up{idx}", ResidualBlock(in_ch + skip_ch.pop(), out_ch, norm=norm,
                                                      dtype=dtype))
            idx += 1
            in_ch = out_ch
            if i > 0:
                self.add_module(f"up{idx}", Upsample(in_ch, dtype=dtype))
                idx += 1
        self.num_up = idx
        self.final_norm = GroupNorm(8, in_ch) if norm else nn.Identity()
        self.final = Conv2d(in_ch, output_fields * time_window, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self.image_proj(_fold_time(x))
        skips = [x]
        for i in range(self.num_down):
            x = getattr(self, f"down{i}")(x)
            skips.append(x)
        x = self.middle(x)
        for i in range(self.num_up):
            block = getattr(self, f"up{i}")
            if isinstance(block, ResidualBlock):
                x = torch.cat([x, skips.pop()], dim=1)
            x = block(x)
        x = self.final(F.gelu(self.final_norm(x), approximate="none"))
        return _unfold_time(x, self.time_window)


@register_model("unet_classic")
class ClassicUnet(nn.Module):
    """Four ClassicUnetBlock encoders with 2x2 max-pools, a bottleneck, and
    four k2 s2 transposed-conv upsamples each followed by a decoder block on
    ``[upsampled, encoder]``."""

    def __init__(self, time_window: int = 5, input_fields: int = 4, output_fields: int = 4,
                 hidden_channels: int = 32, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.time_window = time_window
        hc = hidden_channels
        widths = [hc, 2 * hc, 4 * hc, 8 * hc]
        cin = input_fields * time_window
        for i, w in enumerate(widths, start=1):
            self.add_module(f"encoder{i}", ClassicUnetBlock(cin, w, dtype=dtype))
            cin = w
        self.bottleneck = ClassicUnetBlock(cin, 16 * hc, dtype=dtype)
        cin = 16 * hc
        for i, w in reversed(list(enumerate(widths, start=1))):
            self.add_module(f"upconv{i}", ConvTranspose2d(cin, w, 2, stride=2, dtype=dtype))
            self.add_module(f"decoder{i}", ClassicUnetBlock(2 * w, w, dtype=dtype))
            cin = w
        self.final = Conv2d(hc, output_fields * time_window, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = _fold_time(x)
        encs = []
        for i in range(1, 5):
            x = getattr(self, f"encoder{i}")(x if i == 1 else F.max_pool2d(x, 2))
            encs.append(x)
        x = self.bottleneck(F.max_pool2d(x, 2))
        for i in range(4, 0, -1):
            # A dtype upconv beside a float32 encoder output: the concatenation
            # promotes to float32, as jnp.concatenate does.
            x = torch.cat([getattr(self, f"upconv{i}")(x), encs[i - 1]], dim=1)
            x = getattr(self, f"decoder{i}")(x)
        return _unfold_time(self.final(x), self.time_window)
