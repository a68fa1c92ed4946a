"""Weight bridge: JAX (flax) params -> the port's state_dict.

AViT / FiLMAViT (:func:`jax_params_to_state_dict`) and the U-Nets
(:func:`unet_params_to_state_dict`).  For the AViTs the bridge is

the exact inverse of ``bubbleformer_tpu/utils/convert.py:
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
* the bias module by ``bias_type``: ``RelativePositionBias_0/embedding`` ->
  ``rel_pos_bias.relative_attention_bias.weight``;
  ``ContinuousPositionBias1D_0/{fc1,fc2}`` -> ``rel_pos_bias.cpb_mlp.{0,2}``
  (Linears, fc2 without a bias); nothing for ``"none"``.

``tests/test_torch_bridge.py`` checks the round trip leaf by leaf.

The U-Nets' submodules carry the flax modules' names, so their map is
mechanical: a path's modules joined by ``.``, and per leaf

* Conv kernel ``(kh, kw, I, O)`` -> Conv2d weight ``(O, I, kh, kw)``;
* ConvTranspose kernel (``transpose_kernel=True``, ``(kh, kw, O, I)``:
  ModernUnet's ``up{i}.conv``, ClassicUnet's ``upconv{i}``) ->
  ConvTranspose2d weight ``(I, O, kh, kw)``, the inverse of the JAX
  package's ``w.transpose(2, 3, 1, 0)`` (``convert.py:9-12``): the same
  axes permutation as a Conv's, with no spatial flip;
* GroupNorm / BatchNorm ``scale``/``bias`` -> ``weight``/``bias``;
* ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``.

``tests/test_torch_unets.py`` checks that round trip leaf by leaf.

The reference's own Lightning checkpoints (its model zoo) already carry the
port's keys under a ``model.`` prefix: :func:`load_reference_checkpoint`
reads one (as ``scripts/convert_reference_checkpoint.py:42-57`` does for
the JAX package), :func:`reference_model_cfg` reads the AViT's config off
its weights, and ``scripts/convert_reference_checkpoint_torch.py`` writes
the port's checkpoint from both.
"""
from __future__ import annotations

import math
import pickle
import re
from typing import Any, Dict, Mapping, Optional, Tuple

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
    if "RelativePositionBias_0" in p:
        out[f"{prefix}.rel_pos_bias.relative_attention_bias.weight"] = _t(
            p["RelativePositionBias_0"]["embedding"]
        )
    if "ContinuousPositionBias1D_0" in p:
        mlp = p["ContinuousPositionBias1D_0"]
        _linear(out, f"{prefix}.rel_pos_bias.cpb_mlp.0", mlp["fc1"])
        out[f"{prefix}.rel_pos_bias.cpb_mlp.2.weight"] = _t(np.asarray(mlp["fc2"]["kernel"]).T)
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


def _walk(tree: Mapping, prefix: str = ""):
    """``(path, leaf module dict)`` for every dict of ``tree`` holding arrays."""
    for name, node in tree.items():
        path = f"{prefix}.{name}" if prefix else name
        if any(isinstance(v, Mapping) for v in node.values()):
            yield from _walk(node, path)
        else:
            yield path, node


def unet_params_to_state_dict(params: Mapping[str, Any],
                              batch_stats: Optional[Mapping[str, Any]] = None
                              ) -> Dict[str, torch.Tensor]:
    """JAX ModernUnet / ClassicUnet params (numpy or jax leaves; the
    ``{"params": ..., "batch_stats": ...}`` variables are accepted too) ->
    the port's state_dict, with ClassicUnet's running statistics from
    ``batch_stats``."""
    if "params" in params:
        batch_stats = params.get("batch_stats", batch_stats)
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, p in _walk(params):
        if "kernel" in p:
            # Conv (kh, kw, I, O) and transposed (kh, kw, O, I) alike.
            out[f"{path}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
            if "bias" in p:
                out[f"{path}.bias"] = _t(p["bias"])
        else:
            _norm(out, path, p)
    for path, s in _walk(batch_stats or {}):
        out[f"{path}.running_mean"] = _t(s["mean"])
        out[f"{path}.running_var"] = _t(s["var"])
    return out



def bias_type_of(state_dict: Mapping[str, Any]) -> str:
    """The ``bias_type`` an AViT's state dict was built with: ``"rel"``
    (T5 tables), ``"continuous"`` (``cpb_mlp`` weights) or ``"none"``."""
    if any(k.endswith("rel_pos_bias.relative_attention_bias.weight") for k in state_dict):
        return "rel"
    if any(".rel_pos_bias.cpb_mlp." in k for k in state_dict):
        return "continuous"
    return "none"


def reference_model_cfg(state_dict: Mapping[str, Any], patch_size: int = 16,
                        blocks: int = 12) -> Dict[str, Any]:
    """The model config (``{"name", "params"}``, field counts included) of
    an AViT / FiLMAViT state dict with the port's (the reference's) keys:
    widths, heads, fields, fluid parameters, ``attn_scale``, ``feat_scale``
    and ``bias_type`` read off the weights; ``patch_size`` and ``blocks``
    as given, so a state dict of another depth or patch fails to load
    strictly, naming its keys."""
    sd = state_dict
    embed_dim = sd["blocks.0.temporal.gamma"].shape[0]
    last_debed = 3 * (int(math.log2(patch_size)) - 1)
    params = dict(
        patch_size=patch_size, processor_blocks=blocks, embed_dim=embed_dim,
        num_heads=embed_dim // sd["blocks.0.temporal.qnorm.weight"].shape[0],
        input_fields=sd["embed.in_proj.0.weight"].shape[1],
        output_fields=sd[f"debed.out_proj.{last_debed}.weight"].shape[1],
        attn_scale="blocks.0.temporal.attn_scale_factor" in sd,
        feat_scale="blocks.0.spatial.low_freq_scalar" in sd,
        bias_type=bias_type_of(sd),
    )
    if "film_embed.film_net.1.weight" not in sd:
        return {"name": "avit", "params": params}
    params["num_fluid_params"] = sd["film_embed.film_net.1.weight"].shape[1]
    return {"name": "filmavit", "params": params}


def load_reference_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor],
                                                  Optional[Tuple[Dict, Dict]], int]:
    """``(state_dict, normalization_constants, global_step)`` of a reference
    Lightning ``.ckpt`` (or a bare state dict): the model's tensors with the
    ``model.`` prefix stripped, the ``(diff, div)`` constants from
    ``hyper_parameters["normalization_constants"]`` (None where it has
    none) and ``global_step`` (0 where it has none), as
    ``scripts/convert_reference_checkpoint.py:42-57`` reads them.

    A Lightning checkpoint pickles its hyper-parameters and loop state,
    which may hold objects (a config class, numpy scalars) that torch's
    weights-only unpickler refuses.  Such a file is read again with
    ``weights_only=False``, which runs the pickle's code: read only
    checkpoints from a source you trust.  This function is the port's one
    place that does so."""
    try:
        data = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        data = torch.load(path, map_location="cpu", weights_only=False)
    state = data["state_dict"] if "state_dict" in data else data
    state_dict = {(k[len("model."):] if k.startswith("model.") else k): v
                  for k, v in state.items()}
    hp = data.get("hyper_parameters") or {}
    norm = None
    if hp.get("normalization_constants"):
        diff, div = hp["normalization_constants"]
        norm = ({k: float(v) for k, v in dict(diff).items()},
                {k: float(v) for k, v in dict(div).items()})
    return state_dict, norm, int(data.get("global_step", 0))
