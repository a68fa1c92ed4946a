"""Checkpoints: one ``torch.save`` file per save.

Counterpart of ``bubbleformer_tpu/training/checkpoint.py``: everything a
restore needs travels in one file — the model's state dict, the optimizer
state, the step, the normalization constants and a ``format_version`` —
written to a temporary name and renamed, so a reader never sees half a
file.  A restore that fails raises: there is no params-only fallback.
Preemption checkpoints are numbered ``hpc_ckpt_N.pt`` (``scripts/train.py:
91-96`` of the reference).
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

FORMAT_VERSION = 1


def save_checkpoint(path: str, module) -> None:
    """Write ``module``'s model, optimizer, step and normalization constants."""
    state = {
        "format_version": FORMAT_VERSION,
        "step": module.step,
        "model": module.model.state_dict(),
        "optimizer": module.optimizer.state_dict(),
        "norm_constants": module.normalization_constants,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The saved dict, on the CPU; raises unless it is a checkpoint of this
    format."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or ckpt.get("format_version") != FORMAT_VERSION:
        found = ckpt.get("format_version") if isinstance(ckpt, dict) else type(ckpt).__name__
        raise ValueError(f"{path} is not a checkpoint of format {FORMAT_VERSION} (found {found!r})")
    return ckpt


def restore_checkpoint(path: str, module) -> None:
    """Load model, optimizer, step and normalization constants into
    ``module``; any mismatch raises."""
    ckpt = load_checkpoint(path)
    module.model.load_state_dict(ckpt["model"])
    module.optimizer.load_state_dict(ckpt["optimizer"])
    module.step = int(ckpt["step"])
    if ckpt["norm_constants"] is not None:
        module.normalization_constants = tuple(ckpt["norm_constants"])


def next_preempt_ckpt_path(log_dir: str, resume_path: Optional[str]) -> str:
    """Numbered preemption-checkpoint path: one past the resumed one."""
    m = re.search(r"hpc_ckpt_(\d+)", os.path.basename(resume_path or ""))
    n = int(m.group(1)) + 1 if m else 1
    return os.path.join(log_dir, f"hpc_ckpt_{n}.pt")
