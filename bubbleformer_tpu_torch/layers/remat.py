"""Per-block activation checkpointing: the JAX models' ``remat``.

Counterpart of ``bubbleformer_tpu/models/axial_vit.py:125-146``, where each
SpaceTimeBlock runs under ``nn.remat`` with a policy from
``REMAT_POLICIES``:

* ``"dots"`` (``save_from_both_policies(dots_with_no_batch_dims_saveable,
  save_only_these_names("flash_attn"))``): the block keeps its input, the
  outputs of its 2-D products (the Dense layers,
  :func:`~bubbleformer_tpu_torch.layers.linear.dense`, and the lane route's
  QKV projection) and the outputs of the attention kernels whose JAX VJP
  keeps only their inputs as residuals: K2, K3, K4, K6, K7, K8 and K9
  (their wrappers call :func:`reuse`).  Everything else — InstanceNorms,
  GELU, LayerScale, drop-path, relayouts, casts — is recomputed in the
  backward.  K1 and K5 keep residuals of their own kernels' making (their
  ``ao``), which the policy does not save, so the backward runs their
  forward kernels again, as JAX's does: two forward launches a step.
* ``"full"``: only the block input is kept; the backward reruns the block.

Any other name also recomputes everything: ``REMAT_POLICIES.get`` returns
None for it, which ``nn.remat`` takes as no policy.

The mechanism: :func:`checkpoint_block` runs the block under
``torch.utils.checkpoint`` (non-reentrant), which keeps the block input and
reruns the block when the backward first needs one of its saved tensors.
Under ``"dots"`` a tape records each :func:`reuse` output of the forward;
the tape is saved by a pass-through autograd node after the block (so
``torch.autograd.graph.saved_tensors_hooks`` see it, as they see the block
input), and in the rerun each :func:`reuse` returns its recorded output
instead of computing it again, while the wrappers still save what their
backward reads.  Drop-path draws its masks from a generator the rerun does
not replay, so the models draw each block's masks before the block and hand
the same masks to both runs.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import torch
from torch.utils.checkpoint import checkpoint


class _Tape:
    """The recorded outputs of one block's :func:`reuse` calls, in order."""

    def __init__(self):
        self.items: List = []
        self.sites: List = []  # the kernel (or product) each item came from
        self.replay = False
        self.pos = 0


_active: Optional[_Tape] = None


@contextlib.contextmanager
def _using(tape: _Tape, replay: bool):
    global _active
    outer, _active = _active, tape
    tape.replay, tape.pos = replay, 0
    try:
        yield
    finally:
        _active = outer


def recording() -> bool:
    """True inside a ``"dots"`` block, in its forward and in its rerun."""
    return _active is not None


def reuse(compute: Callable, site):
    """``compute()``, a tensor, recorded inside a ``"dots"`` block; in the
    block's rerun, the recorded value without calling ``compute``.  Outside
    such a block, ``compute()``.  ``site`` names what ``compute`` runs (the
    kernel wrapper): the rerun raises where the sites do not come in the
    forward's order.  What ``compute`` itself calls (a plain version's
    products) is not recorded."""
    global _active
    tape = _active
    if tape is None:
        return compute()
    if tape.replay:
        if tape.pos >= len(tape.sites) or tape.sites[tape.pos] is not site:
            raise RuntimeError(
                "remat: the block's rerun took another path than its forward (did a route "
                "setting such as BUBBLEFORMER_LANE_PROJ change before the backward?)")
        out, tape.items[tape.pos] = tape.items[tape.pos], None
        tape.pos += 1
        return out
    _active = None
    try:
        out = compute()
    finally:
        _active = tape
    tape.items.append(out.detach())
    tape.sites.append(site)
    return out


class _Hold(torch.autograd.Function):
    """Passes the block output through and saves the tape's tensors; its
    backward, which runs before any node of the block, hands them back to the
    tape for the rerun."""

    @staticmethod
    def forward(ctx, tape, out, *kept):
        ctx.tape = tape
        ctx.save_for_backward(*kept)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        ctx.tape.items = list(ctx.saved_tensors)
        return (None, grad, *([None] * len(ctx.tape.items)))


def checkpoint_block(fn: Callable, x: torch.Tensor, policy: str) -> torch.Tensor:
    """``fn(x)`` with its activations recomputed in the backward, keeping
    what ``policy`` keeps (module docstring).  ``fn`` must draw no random
    numbers: the rerun does not restore the random state."""
    if policy != "dots":
        return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False)
    tape = _Tape()
    out = checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False,
                     context_fn=lambda: (_using(tape, False), _using(tape, True)))
    kept = tape.items
    out = _Hold.apply(tape, out, *kept)
    tape.items = [None] * len(kept)
    return out
