"""Model registry and construction from the YAML configs.

Counterpart of ``bubbleformer_tpu/models/_api.py`` plus the model wiring of
``bubbleformer_tpu/training/module.py:64-70``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

MODELS: Dict[str, Callable[..., Any]] = {}


def register_model(name: str) -> Callable:
    """Class decorator registering a model constructor under ``name``."""

    def wrapper(cls):
        key = name.lower()
        if key in MODELS:
            raise ValueError(f"Model {key} already registered")
        MODELS[key] = cls
        return cls

    return wrapper


def list_models() -> List[str]:
    return sorted(MODELS.keys())


def get_model(name: str, **config):
    """Instantiate a registered model by (case-insensitive) name."""
    key = name.lower()
    if key not in MODELS:
        raise KeyError(f"Unknown model {name!r}; available: {list_models()}")
    return MODELS[key](**config)


def build_model(model_cfg: Dict[str, Any], data_cfg: Dict[str, Any],
                compute_dtype: Optional[str] = None):
    """The model of a run config: the data config fixes the field counts and
    the time window; ``compute_dtype`` (e.g. ``"bfloat16"``) sets the
    activation dtype while parameters stay float32."""
    params = dict(model_cfg.get("params", {}))
    params["input_fields"] = len(data_cfg["input_fields"])
    params["output_fields"] = len(data_cfg["output_fields"])
    params["time_window"] = data_cfg["time_window"]
    if compute_dtype is not None:
        params["dtype"] = getattr(torch, compute_dtype)
    return get_model(model_cfg["name"], **params)
