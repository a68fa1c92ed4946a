"""Weight bridge: JAX (flax) AViT / FiLMAViT params -> the port's state_dict.

The exact inverse of ``bubbleformer_tpu/utils/convert.py:
convert_avit_state_dict`` (``:125-155``), whose keys are the reference torch
model's and therefore the port's:

* Dense kernel ``(I, O)`` -> Linear weight ``(O, I)``; as a 1x1 conv (the
  attention heads) ``(O, I, 1, 1)``.  The heads-major ``[q|k|v]`` column
  order of the QKV projection is kept as it is.
* embed conv kernel ``(2, 2, I, O)`` -> Conv2d weight ``(O, I, 2, 2)``.
* debed transposed-conv kernel (flax's spatially flipped convention) ->
  ConvTranspose2d weight ``(I, O, 2, 2)``, flipped back.
* norm ``scale``/``bias`` -> ``weight``/``bias``; attn scales ``(heads,)`` ->
  ``(1, heads, 1, 1)``.

``tests/test_torch_bridge.py`` checks the round trip leaf by leaf.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable, contiguous copy


def _norm(out: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _conv1x1(out: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None, None])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _linear(out: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{prefix}.bias"] = _t(p["bias"])


def _attention_block(out: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    for name in ("norm1", "norm2", "qnorm", "knorm"):
        _norm(out, f"{prefix}.{name}", p[name])
    _conv1x1(out, f"{prefix}.input_head", p["input_head"])
    _conv1x1(out, f"{prefix}.output_head", p["output_head"])
    out[f"{prefix}.rel_pos_bias.relative_attention_bias.weight"] = _t(
        p["RelativePositionBias_0"]["embedding"]
    )
    for name in ("gamma", "gamma_att", "gamma_mlp", "low_freq_scalar", "high_freq_scalar"):
        if name in p:
            out[f"{prefix}.{name}"] = _t(p[name])
    for name in ("attn_scale_factor", "attn_scale_factor_x", "attn_scale_factor_y"):
        if name in p:
            out[f"{prefix}.{name}"] = _t(np.asarray(p[name]).reshape(1, -1, 1, 1))
    if "mlp" in p:
        _linear(out, f"{prefix}.mlp.fc1", p["mlp"]["fc1"])
        _linear(out, f"{prefix}.mlp.fc2", p["mlp"]["fc2"])
        _norm(out, f"{prefix}.mlp_norm", p["mlp_norm"])


def _count(p: Mapping, pattern: str) -> int:
    return sum(1 for k in p if re.fullmatch(pattern, k))


def jax_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Unrolled JAX AViT/FiLMAViT params (numpy or jax leaves; the
    ``{"params": ...}`` wrapper is accepted too) -> the port's state_dict."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    embed, debed = params["embed"], params["debed"]
    for i in range(_count(embed, r"conv\d+")):
        kernel = np.asarray(embed[f"conv{i}"]["kernel"])  # (kh, kw, I, O)
        out[f"embed.in_proj.{3 * i}.weight"] = _t(kernel.transpose(3, 2, 0, 1))
        _norm(out, f"embed.in_proj.{3 * i + 1}", embed[f"norm{i}"])
    for i in range(_count(debed, r"deconv\d+")):
        kernel = np.asarray(debed[f"deconv{i}"]["kernel"])  # flipped (kh, kw, I, O)
        out[f"debed.out_proj.{3 * i}.weight"] = _t(kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
        if f"norm{i}" in debed:
            _norm(out, f"debed.out_proj.{3 * i + 1}", debed[f"norm{i}"])
    for i in range(_count(params, r"block\d+")):
        _attention_block(out, f"blocks.{i}.temporal", params[f"block{i}"]["temporal"])
        _attention_block(out, f"blocks.{i}.spatial", params[f"block{i}"]["spatial"])
    if "film_embed" in params:
        _norm(out, "film_embed.film_net.0", params["film_embed"]["norm"])
        _linear(out, "film_embed.film_net.1", params["film_embed"]["proj"])
    return out
