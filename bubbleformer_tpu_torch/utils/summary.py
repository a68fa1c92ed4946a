"""Parameter summary table printed by ``Trainer.fit``.

Counterpart of ``bubbleformer_tpu/utils/summary.py`` over a module's
``named_parameters``.
"""
from __future__ import annotations

from torch import nn


def parameter_table(model: nn.Module, max_rows: int = 200) -> str:
    """Human-readable table: parameter name, shape, count, plus the total."""
    rows = [(name, tuple(p.shape), p.numel()) for name, p in model.named_parameters()]
    total = sum(r[2] for r in rows)
    width = min(max((len(r[0]) for r in rows), default=10) + 2, 70)
    lines = [f"{'name':<{width}}{'shape':<24}{'params':>12}", "-" * (width + 36)]
    for name, shape, count in rows[:max_rows]:
        lines.append(f"{name[:width - 1]:<{width}}{str(shape):<24}{count:>12,}")
    if len(rows) > max_rows:
        lines.append(f"... ({len(rows) - max_rows} more)")
    lines += ["-" * (width + 36), f"{'total':<{width}}{'':<24}{total:>12,}"]
    return "\n".join(lines)


def count_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
