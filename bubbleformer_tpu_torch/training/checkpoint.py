"""Checkpoints: one ``torch.save`` file per save.

Counterpart of ``bubbleformer_tpu/training/checkpoint.py``: everything a
restore needs travels in one file — the model's state dict, the optimizer
state, the step, the normalization constants and a ``format_version`` —
written to a temporary name and renamed, so a reader never sees half a
file.  A restore that fails raises: there is no params-only fallback.  In a
world of processes the trainer has the leader write (``Trainer.save``) and
every rank restore, each onto its own device.  Under tensor parallelism
(the module's ``model_shard``) a checkpoint is still whole, in the
one-process format: :func:`checkpoint_state` gathers the parameters and
the optimizer state (Lion's momentum, AdamW's moments) over the model group
on every rank, and :func:`restore_checkpoint` keeps the rank's slices of a
whole checkpoint.  So ``scripts/inference_torch.py`` rolls a ``dp_tp``
checkpoint out on one card, ``mesh_cfg=single`` resumes it, and ``dp_tp``
resumes a ``single`` one.
Preemption checkpoints are numbered ``hpc_ckpt_N.pt`` (``scripts/train.py:
91-96`` of the reference).
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

from bubbleformer_tpu_torch.parallel.sharding import (
    gather_full_state,
    gather_optimizer_state,
    shard_optimizer_state,
    shard_state,
)

FORMAT_VERSION = 1


def checkpoint_state(module) -> Dict[str, Any]:
    """What a checkpoint of ``module`` holds: its model, optimizer, step and
    normalization constants, whole.  Under tensor parallelism the sharded
    entries are gathered over the model group: every model rank calls it."""
    model, optimizer = module.model.state_dict(), module.optimizer.state_dict()
    shard = getattr(module, "model_shard", None)
    if shard is not None:
        names = [n for n, _ in module.model.named_parameters()]
        model = gather_full_state(model, shard)
        optimizer = gather_optimizer_state(optimizer, names, shard)
    return {
        "format_version": FORMAT_VERSION,
        "step": module.step,
        "model": model,
        "optimizer": optimizer,
        "norm_constants": module.normalization_constants,
    }


def save_checkpoint(path: str, module, state: Optional[Dict[str, Any]] = None) -> None:
    """Write ``module``'s checkpoint (``state``, :func:`checkpoint_state`'s,
    where the caller gathered it)."""
    state = checkpoint_state(module) if state is None else state
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location: Any = "cpu") -> Dict[str, Any]:
    """The saved dict, its tensors on ``map_location`` (the CPU by default);
    raises unless it is a checkpoint of this format."""
    ckpt = torch.load(path, map_location=map_location, weights_only=True)
    if not isinstance(ckpt, dict) or ckpt.get("format_version") != FORMAT_VERSION:
        found = ckpt.get("format_version") if isinstance(ckpt, dict) else type(ckpt).__name__
        raise ValueError(f"{path} is not a checkpoint of format {FORMAT_VERSION} (found {found!r})")
    return ckpt


def restore_checkpoint(path: str, module) -> None:
    """Load model, optimizer, step and normalization constants into
    ``module``, read straight onto its device (under tensor parallelism the
    rank's slices of the whole checkpoint); any mismatch raises."""
    ckpt = load_checkpoint(path, map_location=module.device)
    model, optimizer = ckpt["model"], ckpt["optimizer"]
    shard = getattr(module, "model_shard", None)
    if shard is not None:
        names = [n for n, _ in module.model.named_parameters()]
        model, optimizer = shard_state(model, shard), shard_optimizer_state(optimizer, names, shard)
    module.model.load_state_dict(model)
    module.optimizer.load_state_dict(optimizer)
    module.step = int(ckpt["step"])
    if ckpt["norm_constants"] is not None:
        module.normalization_constants = tuple(ckpt["norm_constants"])


def next_preempt_ckpt_path(log_dir: str, resume_path: Optional[str]) -> str:
    """Numbered preemption-checkpoint path: one past the resumed one."""
    m = re.search(r"hpc_ckpt_(\d+)", os.path.basename(resume_path or ""))
    n = int(m.group(1)) + 1 if m else 1
    return os.path.join(log_dir, f"hpc_ckpt_{n}.pt")
