"""Per-block activation checkpointing (the JAX models' ``remat``,
``layers/remat.py``) on the CPU: the models give bit-identical losses and
gradients with ``remat=False``, ``"dots"`` and ``"full"`` (drop-path on, its
masks drawn from an explicit generator, which a rerun must not draw again);
what each policy keeps per block, seen by ``saved_tensors_hooks`` (the
counterpart of ``tests/test_axial_lane.py::
test_lean_projection_dot_not_saved_by_dots_policy``: under ``"dots"`` K9
keeps nothing 3C wide and the XLA-projection lane route keeps its
projection); how often the backward reruns each kernel's forward, which the
card's launch counts follow (``chip_smoke.py``); and an unknown policy name
taken as ``"full"``, as ``REMAT_POLICIES.get`` makes it in the JAX package.
"""
import os
from unittest import mock

import numpy as np
import pytest
import torch

from bubbleformer_tpu_torch.layers import remat
from bubbleformer_tpu_torch.models import get_model
from bubbleformer_tpu_torch.models.axial_vit import SpaceTimeBlock
from bubbleformer_tpu_torch.ops import axial_lane, axial_lane_px, temporal_block_mega
from tests._torch_grads import single_thread

C, HEADS = 96, 6  # film_avit_tiny's width: 6 heads of 16
GRID = (8, 16)  # tokens: inside the mega and lane gates
# route: (attn_impl, environment); "auto" takes K1 and the lane route here.
ROUTES = {"K1 K2": ("auto", {}), "K1 K9": ("auto", {"BUBBLEFORMER_LANE_PROJ": "kernel"}),
          "core": ("core", {}), "fused_block": ("fused_block", {})}


def _model(remat_on, policy, attn_impl, blocks=2):
    torch.manual_seed(0)
    m = get_model("filmavit", input_fields=4, output_fields=4, time_window=5, patch_size=8,
                  embed_dim=C, num_heads=HEADS, processor_blocks=blocks, drop_path=0.5,
                  attn_impl=attn_impl, remat=remat_on, remat_policy=policy,
                  num_fluid_params=9)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            a = rng.standard_normal(p.shape) * 0.2
            if name.endswith(("gamma", "gamma_att", "gamma_mlp")) or p.ndim == 1 and \
                    name.endswith("weight"):
                a = a + 1.0
            p.copy_(torch.from_numpy(a.astype(np.float32)))
    return m.train()


def _step(remat_on, policy, route):
    """Loss and gradients of one training-mode step, drop-path masks from a
    generator seeded the same way on every call."""
    attn_impl, env = ROUTES[route]
    with single_thread(), mock.patch.dict(os.environ, env):
        m = _model(remat_on, policy, attn_impl)
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.standard_normal((2, 5, 4, 8 * GRID[0], 8 * GRID[1]))
                             .astype(np.float32))
        cond = torch.from_numpy(rng.standard_normal((2, 9)).astype(np.float32))
        y = m(x, cond, generator=torch.Generator().manual_seed(3))
        loss = (y.float() ** 2).mean()
        loss.backward()
    return loss.detach(), {n: p.grad for n, p in m.named_parameters()}


@pytest.mark.parametrize("policy", ["dots", "full", "no such policy"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_remat_gives_bit_identical_losses_and_gradients(route, policy):
    """K1 + K2, K1 + K9 (the lane route with the projection in the kernel),
    K3 and the XLA plain axial route (core), and the XLA temporal route + K4
    (fused_block), their plain versions: drop-path at up to 0.5 with masks
    from an explicit generator, so a rerun that drew its own masks would
    change the gradients."""
    ref_loss, ref = _step(False, "dots", route)
    loss, grads = _step(True, policy, route)
    assert torch.equal(loss, ref_loss)
    assert grads.keys() == ref.keys()
    for name, g in grads.items():
        assert g is not None and torch.equal(g, ref[name]), name


def _saved_per_block(route_env, policy, attn_impl="auto", seed=4):
    """``(shape, dtype, bytes)`` of every tensor ``saved_tensors_hooks`` see
    for one SpaceTimeBlock (8x16 tokens, width 96; ``auto``: temporal K1,
    axial lane) under ``policy``, and the block input's shape."""
    torch.manual_seed(seed)
    block = SpaceTimeBlock(C, HEADS, attn_impl=attn_impl).train()
    x = torch.randn(2, 5, *GRID, C, requires_grad=True)
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype, t.numel() * t.element_size()))
        return t

    with mock.patch.dict(os.environ, route_env):
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = remat.checkpoint_block(lambda y: block(y), x, policy)
        out.sum().backward()
    return saved, tuple(x.shape)


def test_dots_keeps_no_projection_on_k9_and_keeps_it_on_the_xla_projection():
    """Under "dots" the block keeps its input, its Dense outputs (the axial
    output projection, the MLP's two products) and the attention kernels'
    outputs (K2's or K9's; K1, the temporal branch here, is recomputed):
    with K9 nothing 3C wide, with the XLA projection its float32 (R, 3C)
    product as well.  "full" keeps the block input alone."""
    kept_k9, x_shape = _saved_per_block({"BUBBLEFORMER_LANE_PROJ": "kernel"}, "dots")
    kept_xla, _ = _saved_per_block({}, "dots")
    tokens = 2 * 5 * GRID[0] * GRID[1]
    assert not [s for s in kept_k9 if s[0][-1] == 3 * C]
    wide = [s for s in kept_xla if s[0][-1] == 3 * C]
    assert wide == [((tokens, 3 * C), torch.float32, tokens * 3 * C * 4)]
    # Everything else is the same: the block input, K2's or K9's output
    # (C wide), the output projection (C), the MLP's products (4C, C).
    others = sorted(s for s in kept_xla if s[0][-1] != 3 * C)
    assert sorted(kept_k9) == others
    widths = sorted(s[0][-1] for s in kept_k9)
    assert widths == [C, C, C, C, 4 * C]
    assert (x_shape, torch.float32, tokens * C * 4) in kept_k9
    full, _ = _saved_per_block({"BUBBLEFORMER_LANE_PROJ": "kernel"}, "full")
    assert full == [(x_shape, torch.float32, tokens * C * 4)]


def test_unknown_policy_keeps_what_full_keeps():
    """``REMAT_POLICIES.get`` returns None for a name it does not know, which
    ``nn.remat`` takes as full recompute; the port does the same."""
    for env in ({}, {"BUBBLEFORMER_LANE_PROJ": "kernel"}):
        assert _saved_per_block(env, "dotz")[0] == _saved_per_block(env, "full")[0]


def test_rerun_on_another_route_raises():
    """A rerun that takes another path than the forward (here: the lane
    projection switched between the forward and the backward) raises rather
    than hand the kept outputs to the wrong calls."""
    torch.manual_seed(5)
    block = SpaceTimeBlock(C, HEADS).train()
    x = torch.randn(1, 5, *GRID, C, requires_grad=True)
    with mock.patch.dict(os.environ, {"BUBBLEFORMER_LANE_PROJ": "kernel"}):
        out = remat.checkpoint_block(lambda y: block(y), x, "dots")
    with pytest.raises(RuntimeError, match="another path"):
        out.sum().backward()


def test_rerun_with_another_kernel_at_the_same_place_raises():
    """The guard keys on the kernel each kept output came from, not on the
    code that called it: a rerun that swaps one kernel for another of the
    same kind, through the same call, raises."""
    kernels = [lambda y: y * 2, lambda y: y * 3]
    runs = []

    def block(y):
        fwd = kernels[len(runs)]
        runs.append(fwd)
        return remat.reuse(lambda: fwd(y), site=fwd).sin()

    out = remat.checkpoint_block(block, torch.randn(4, 8, requires_grad=True), "dots")
    with pytest.raises(RuntimeError, match="another path"):
        out.sum().backward()
    assert len(runs) == 2


@pytest.mark.parametrize("policy,k1_runs,axial_runs", [
    ("dots", 2, 1), ("full", 2, 2), (None, 1, 1)], ids=["dots", "full", "off"])
def test_backward_reruns_the_forwards_the_jax_policy_recomputes(policy, k1_runs, axial_runs):
    """Forward runs per block and step of the temporal branch (K1, whose JAX
    VJP keeps its ``ao``, a residual of its own kernel, so "dots" reruns it)
    and of the axial attention (K9 and K2, whose JAX VJPs keep their inputs:
    "dots" keeps their outputs and does not rerun them), counted on their
    plain versions; the card's launch counts are these."""
    blocks = 2
    for route, fn, module in (("K1 K9", "lane_px_plain", axial_lane_px),
                              ("K1 K2", "axial_attention_plain", axial_lane)):
        calls = {"k1": 0, "axial": 0}

        def counted(key, real):
            def run(*a, **k):
                calls[key] += 1
                return real(*a, **k)
            return run

        with mock.patch.object(temporal_block_mega, "temporal_branch_plain",
                               counted("k1", temporal_block_mega.temporal_branch_plain)), \
                mock.patch.object(module, fn, counted("axial", getattr(module, fn))):
            _step(policy is not None, policy or "dots", route)
        assert calls == {"k1": k1_runs * blocks, "axial": axial_runs * blocks}, (route, calls)
