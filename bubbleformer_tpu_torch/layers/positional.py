"""T5 bucketed relative position bias.

Counterpart of ``bubbleformer_tpu/layers/positional.py`` (``bias_type="rel"``
only; ``ContinuousPositionBias1D`` is not ported yet).  The bucket table is
computed in numpy from static sequence lengths and gathers rows of a learned
``(num_buckets, heads)`` embedding.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from bubbleformer_tpu_torch.layers.norm import accumulation_dtype


def t5_relative_position_bucket(relative_position: np.ndarray, bidirectional: bool = True,
                                num_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """Map integer relative positions to T5 bucket ids (Mesh-TensorFlow scheme):
    half the buckets cover exact small offsets, the other half log-spaced
    offsets up to ``max_distance``."""
    relative_position = np.asarray(relative_position, dtype=np.int64)
    ret = np.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret += (n < 0).astype(np.int64) * num_buckets
        n = np.abs(n)
    else:
        n = np.maximum(n, 0)

    max_exact = num_buckets // 2
    is_small = n < max_exact
    with np.errstate(divide="ignore"):
        val_if_large = max_exact + (
            np.log(np.maximum(n, 1).astype(np.float64) / max_exact)
            / math.log(max_distance / max_exact)
            * (num_buckets - max_exact)
        ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    ret += np.where(is_small, n, val_if_large)
    return ret


def t5_bucket_table(qlen: int, klen: int, bidirectional: bool = True,
                    num_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """``(qlen, klen)`` int table of bucket ids."""
    relative_position = (
        np.arange(klen, dtype=np.int64)[None, :] - np.arange(qlen, dtype=np.int64)[:, None]
    )
    return t5_relative_position_bucket(
        relative_position, bidirectional=bidirectional,
        num_buckets=num_buckets, max_distance=max_distance,
    )


class RelativePositionBias(nn.Module):
    """Returns a ``(heads, qlen, klen)`` float32 additive bias (float64 for a
    float64 table).

    ``max_distance`` is 32, not the reference constructor's 128: the
    reference's ``compute_bias`` never forwards its attribute to the bucket
    function, so 32 is what runs (``bubbleformer_tpu/layers/positional.py:
    91-102``).  One instance per attention block is evaluated at every
    length the block needs ((T, T), or (W, W) and (H, H)).
    """

    def __init__(self, num_heads: int, bidirectional: bool = True,
                 num_buckets: int = 32, max_distance: int = 32):
        super().__init__()
        self.bidirectional = bidirectional
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, num_heads)
        # Bucket ids per (qlen, klen, device): static, so built once.
        self._buckets: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def forward(self, qlen: int, klen: int) -> torch.Tensor:
        table = self.relative_attention_bias.weight
        key = (qlen, klen, table.device)
        if key not in self._buckets:
            ids = t5_bucket_table(qlen, klen, self.bidirectional,
                                  self.num_buckets, self.max_distance)
            self._buckets[key] = torch.as_tensor(ids, device=table.device)
        return table[self._buckets[key]].permute(2, 0, 1).to(accumulation_dtype(table.dtype))
