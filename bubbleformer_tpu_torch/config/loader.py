"""YAML config composition over the port's own copy of the config files.

The same composition as ``bubbleformer_tpu/config/loader.py`` (defaults list
-> group files -> ``key=value`` overrides) over the YAML files beside this
module: ``default.yaml`` and the ``data_cfg``, ``model_cfg``, ``optim_cfg``,
``scheduler_cfg`` and ``mesh_cfg`` groups, copied from
``bubbleformer_tpu/config/`` (``tests/test_torch_config.py`` holds each copy
equal to its original).  The composed config carries ``mesh_cfg`` as the
JAX loader's does; ``parallel/mesh.py:make_mesh`` reads it, running
``single`` (data parallelism over every process) and raising ``ValueError``
for a ``model`` or ``spatial`` axis (``dp_tp``, ``dp_sp``,
``mesh_cfg.model=2``), which the port does not have.  ``yaml`` is imported
only when a file is read.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional

GROUPS = ("data_cfg", "model_cfg", "optim_cfg", "scheduler_cfg", "mesh_cfg")

DEFAULT_CONFIG_DIR = str(Path(__file__).resolve().parent)


def _yaml():
    try:
        import yaml
    except ImportError as exc:
        raise ImportError(
            "reading config files needs PyYAML (pip install pyyaml)"
        ) from exc
    return yaml


def _load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return _yaml().safe_load(f) or {}


def _set_dotted(cfg: Dict[str, Any], key: str, value: Any) -> None:
    parts = key.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def load_config(overrides: Optional[List[str]] = None, config_dir: str = DEFAULT_CONFIG_DIR,
                config_name: str = "default") -> Dict[str, Any]:
    """Compose the run config: defaults -> group files -> CLI overrides."""
    overrides = list(overrides or [])
    root = _load_yaml(os.path.join(config_dir, f"{config_name}.yaml"))
    defaults = root.pop("defaults", [])

    selections: Dict[str, str] = {}
    for entry in defaults:
        if isinstance(entry, dict):
            selections.update(entry)

    value_overrides = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override {ov!r} must be key=value")
        key, _, raw = ov.partition("=")
        if key in GROUPS:
            selections[key] = raw
        else:
            value_overrides.append((key, _yaml().safe_load(raw)))

    cfg = dict(root)
    for group, name in selections.items():
        cfg[group] = _load_yaml(os.path.join(config_dir, group, f"{name}.yaml"))
    for key, value in value_overrides:
        _set_dotted(cfg, key, value)
    return _expand_env(cfg)


def _expand_env(node: Any) -> Any:
    """Expand ``${VAR}`` in string leaves."""
    if isinstance(node, dict):
        return {k: _expand_env(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_expand_env(v) for v in node]
    if isinstance(node, str):
        return os.path.expandvars(node)
    return node
