"""The port's kernel wrappers: on CPU tensors they take the plain version and
count no launch; on a CUDA card (tests marked ``cuda``, skipped without one)
each kernel is held against its plain version at the shapes of the
rollout (batch 1) and of the training step (batch 8), and at smaller ones:
K1 and K2 at FiLMAViT-small's width (C=384), K3 and K2 at AViT-big's
(C=768), K3 also at FiLMAViT-small's 1024x1024 token grid; K2 and K4 on
lines longer than one 64-token tile (the 32x128 flow-boiling grid, lines of
512 and ragged tiles) and at head dim 16 (AViT-tiny); K1 and K3 at head dim
16 (AViT-tiny at 512x512 and 512x2048); K5 (the mega route of the axial
block), K6 and K7 (fused_packed, fused) at their paths' shapes, at head dim
16 and on long lines; K8 (flash) at path F's temporal lines of 5 and axial
lines of 32, at head dims 16 and 64 and on long lines; K10 (the loss's
plane norms) at path F's step shape and a ragged one; K9 (the lane route
with the projection in the kernel) at FiLMAViT-small's rollout and training
shapes, the flow-boiling grid's, AViT-tiny's at 512x512 and a small one,
forward and every gradient, float32 against its plain version in float64
and bfloat16 against it in bfloat16.

This file imports no JAX, so the ``cuda`` tests also run where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Card tolerances, as in ``chip_smoke.py``: 1e-4 (float32, summation order
only) and 2e-2 (bfloat16, single-ulp rounding flips and what they propagate
into) of the reference's largest magnitude.  The backward kernels are held
to the same, gradient by gradient (``tests/_torch_grads.py``): their float32
sums are also reordered by atomics from run to run.
"""
import re

import numpy as np
import pytest
import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.ops import axial_block_mega, temporal_block_mega
from bubbleformer_tpu_torch.ops.axial_block_mega import (
    mega_axial_block,
    mega_axial_block_bwd,
    mega_axial_block_fwd,
    mega_axial_bwd_plain,
    mega_axial_plain,
)
from bubbleformer_tpu_torch.ops.axial_fused import (
    fused_axial_attention,
    fused_axial_attention_bwd,
    fused_bwd_plain,
    fused_plain,
)
from bubbleformer_tpu_torch.ops.axial_fused_block import (
    fused_block_attention,
    fused_block_attention_bwd,
    fused_block_bwd_plain,
    fused_block_plain,
)
from bubbleformer_tpu_torch.ops.axial_fused_packed import (
    fused_axial_attention_packed,
    fused_axial_attention_packed_bwd,
    fused_packed_bwd_plain,
    fused_packed_plain,
)
from bubbleformer_tpu_torch.ops.axial_lane import (
    axial_attention_bwd_plain,
    axial_attention_plain,
    kernel_params,
    lane_axial_attention,
    lane_axial_attention_bwd,
)
from bubbleformer_tpu_torch.ops.axial_lane_px import (
    lane_px_attention,
    lane_px_attention_bwd,
    lane_px_bwd_plain,
    lane_px_plain,
)
from bubbleformer_tpu_torch.ops.axial_pallas import (
    flash_bwd_plain,
    flash_packed_attention,
    flash_packed_attention_bwd,
    flash_plain,
)
from bubbleformer_tpu_torch.ops.lp_loss import (
    plane_norms,
    plane_norms_bwd,
    plane_norms_bwd_plain,
    plane_norms_plain,
    training_lp_loss,
)
from bubbleformer_tpu_torch.ops.temporal_block_mega import (
    core_temporal_attention,
    core_temporal_attention_bwd,
    core_temporal_bwd_plain,
    core_temporal_plain,
    mega_temporal_block,
    mega_temporal_block_bwd,
    mega_temporal_block_fwd,
    temporal_branch_bwd_plain,
    temporal_branch_plain,
)
from tests._torch_grads import check_grads

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _k1_args(shape, heads, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    b, t, h, w, c = shape
    d = c // heads

    def n(*s, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(s)).astype(np.float32))

    args = dict(
        x=n(*shape).to(dtype), in1_scale=n(c, scale=0.2, offset=1.0), in1_bias=n(c, scale=0.2),
        wqkv=n(3 * c, c, scale=c**-0.5), bqkv=n(3 * c, scale=0.2),
        qn_scale=n(d, scale=0.2, offset=1.0), qn_bias=n(d, scale=0.2),
        kn_scale=n(d, scale=0.2, offset=1.0), kn_bias=n(d, scale=0.2),
        in2_scale=n(c, scale=0.2, offset=1.0), in2_bias=n(c, scale=0.2),
        wout=n(c, c, scale=c**-0.5), bout=n(c, scale=0.2), bias=n(heads, t, t),
        scale_factor=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)),
    )
    return {k: v.to(device) for k, v in args.items()}


def _k3_args(shape, heads, seed, dtype=torch.float32, device="cpu"):
    args = _k1_args(shape, heads, seed, dtype, device)
    return {"xn": args["x"], **{k: args[k] for k in (
        "wqkv", "bqkv", "qn_scale", "qn_bias", "kn_scale", "kn_bias", "bias", "scale_factor")}}


def _k2_args(bt, h, w, c, heads, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    d = c // heads

    def n(*s, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(s)).astype(np.float32))

    args = dict(
        qkv=n(bt, h, w, 3 * c).to(dtype), qn_scale=n(d, scale=0.2, offset=1.0),
        qn_bias=n(d, scale=0.2), kn_scale=n(d, scale=0.2, offset=1.0), kn_bias=n(d, scale=0.2),
        bias_x=n(heads, w, w), bias_y=n(heads, h, h),
        scale_x=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)),
        scale_y=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)),
    )
    return {k: v.to(device) for k, v in args.items()}


def test_k1_wrapper_takes_plain_version_on_cpu():
    args = _k1_args((1, 3, 4, 8, 16), 2, 0)
    before = mega_temporal_block.launches
    got = mega_temporal_block(**args, heads=2)
    assert mega_temporal_block.launches == before
    torch.testing.assert_close(got, temporal_branch_plain(**args, heads=2), rtol=0, atol=0)


def test_k2_wrapper_takes_plain_version_on_cpu():
    args = _k2_args(2, 4, 6, 16, 2, 1)
    before = lane_axial_attention.launches
    got = lane_axial_attention(**args, heads=2)
    assert lane_axial_attention.launches == before
    torch.testing.assert_close(got, axial_attention_plain(**args, heads=2), rtol=0, atol=0)


def test_k4_wrapper_takes_plain_version_on_cpu():
    args = _k2_args(2, 4, 6, 16, 2, 1)
    before = (fused_block_attention.launches, fused_block_attention_bwd.launches)
    got = fused_block_attention(**args, heads=2)
    do = torch.ones_like(got)
    grads = fused_block_attention_bwd(do, *args.values(), heads=2)
    assert (fused_block_attention.launches, fused_block_attention_bwd.launches) == before
    torch.testing.assert_close(got, fused_block_plain(**args, heads=2), rtol=0, atol=0)
    for g, w in zip(grads, fused_block_bwd_plain(do, **args, heads=2)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("grid,c,heads,why", [
    ((2, 8, 8), 64, 2, "head_dim in"),    # d = 32
    ((1, 8, 600), 128, 2, "at most 512"),  # a row of 600 tokens
], ids=["head_dim_32", "line_600"])
def test_line_kernels_reject_shapes_outside_their_envelope(grid, c, heads, why):
    """The line kernels' envelope (head dim 16 or 64, lines of at most 512
    tokens) is checked before any launch; a miss names the shape."""
    args = list(_k2_args(*grid, c, heads, 4).values())
    with pytest.raises(ValueError, match=why) as err:
        kernel_params(*args, heads, "fused_block_attention")
    assert str(tuple(args[0].shape)) in str(err.value)


def test_k3_wrapper_takes_plain_version_on_cpu():
    args = _k3_args((1, 3, 4, 8, 16), 2, 0)
    before = core_temporal_attention.launches
    got = core_temporal_attention(**args, heads=2)
    assert core_temporal_attention.launches == before
    torch.testing.assert_close(got, core_temporal_plain(**args, heads=2), rtol=0, atol=0)


def test_wrappers_raise_on_other_devices():
    k1 = {k: v.to("meta") for k, v in _k1_args((1, 3, 4, 8, 16), 2, 0).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        mega_temporal_block(**k1, heads=2)
    k3 = {k: v.to("meta") for k, v in _k3_args((1, 3, 4, 8, 16), 2, 0).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        core_temporal_attention(**k3, heads=2)
    k2 = {k: v.to("meta") for k, v in _k2_args(2, 4, 6, 16, 2, 1).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        lane_axial_attention(**k2, heads=2)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_block_attention(**k2, heads=2)


def test_check_shapes_rejects_a_wrong_shape():
    _build.check_shapes("k", a=(torch.zeros(2, 3), (2, 3)))
    with pytest.raises(ValueError, match=r"k: b has shape \(3,\), expected \(4,\)"):
        _build.check_shapes("k", b=(torch.zeros(3), (4,)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


def _close(got, ref, dtype):
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 5, 32, 32, 384), (8, 5, 32, 32, 384), (2, 3, 8, 16, 128)],
                         ids=["slice", "training", "small"])
def test_k1_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    heads = shape[-1] // 64
    args = _k1_args(shape, heads, 2, dtype, cuda_device)
    before = mega_temporal_block.launches
    got = mega_temporal_block(**args, heads=heads)
    assert mega_temporal_block.launches == before + 1
    _close(got, temporal_branch_plain(**args, heads=heads), dtype)


# K2 at FiLMAViT-small's width (C=384, 6 heads) and at AViT-big's (C=768, 12
# heads), on the rollout's and the training step's grids and two others.
K2_CASES = [((5, 32, 32), 384), ((40, 32, 32), 384), ((2, 16, 40), 384), ((3, 64, 8), 384),
            ((5, 32, 32), 768), ((40, 32, 32), 768)]
K2_IDS = ["slice", "training", "wide", "tall", "big_slice", "big_training"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("grid,c", K2_CASES, ids=K2_IDS)
def test_k2_kernel_matches_plain_on_card(cuda_device, grid, c, dtype):
    bt, h, w = grid
    heads = c // 64
    args = _k2_args(bt, h, w, c, heads, 3, dtype, cuda_device)
    before = lane_axial_attention.launches
    got = lane_axial_attention(**args, heads=heads)
    assert lane_axial_attention.launches == before + 1
    _close(got, axial_attention_plain(**args, heads=heads), dtype)


# K3 at AViT-big's rollout and training shapes, FiLMAViT-small's 1024x1024
# grid, and a small one.
K3_SHAPES = [(1, 5, 32, 32, 768), (8, 5, 32, 32, 768), (2, 5, 64, 64, 384), (2, 3, 8, 16, 128)]
K3_IDS = ["slice", "training", "grid_1024", "small"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", K3_SHAPES, ids=K3_IDS)
def test_k3_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    heads = shape[-1] // 64
    args = _k3_args(shape, heads, 14, dtype, cuda_device)
    before = core_temporal_attention.launches
    got = core_temporal_attention(**args, heads=heads)
    assert core_temporal_attention.launches == before + 1 and got.dtype == dtype
    _close(got, core_temporal_plain(**args, heads=heads), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", K3_SHAPES, ids=K3_IDS)
def test_k3_backward_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    heads = shape[-1] // 64
    args = _k3_args(shape, heads, 15, dtype, cuda_device)
    dao = torch.randn(shape, generator=torch.Generator().manual_seed(16)).to(cuda_device, dtype)
    params = list(args.values())[1:]
    before = core_temporal_attention_bwd.launches
    got = core_temporal_attention_bwd(dao, args["xn"], *params, heads=heads)
    assert core_temporal_attention_bwd.launches == before + 1
    want = core_temporal_bwd_plain(dao, **args, heads=heads)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and all(torch.isfinite(g.float()).all() for g in got)
    check_grads(list(args), [g.cpu() for g in got], [w.float().cpu().numpy() for w in want],
                TOL[dtype])


@pytest.mark.cuda
def test_k1_kernel_statistics_hold_a_large_channel_mean(cuda_device):
    """Channels far above their spread (x ~ 64 + N(0, 1), as FiLM with
    |beta| >> |gamma| leaves them, E[x^2] ~4000 times the variance): the
    kernel's InstanceNorm statistics, summed on values shifted by a sample
    of their plane, stay as close to a float64 run as anywhere else."""
    shape, heads = (1, 5, 32, 32, 384), 6
    args = _k1_args(shape, heads, 13, torch.float32, cuda_device)
    args["x"] = args["x"] + 64.0
    got = mega_temporal_block(**args, heads=heads)
    _close(got, temporal_branch_plain(**{k: v.double() for k, v in args.items()}, heads=heads),
           torch.float32)


@pytest.mark.cuda
def test_kernels_reject_mismatched_shapes_on_card(cuda_device):
    k1 = _k1_args((1, 3, 4, 8, 128), 2, 5, device=cuda_device)
    with pytest.raises(ValueError, match="bias"):
        mega_temporal_block(**dict(k1, bias=k1["bias"][:, :2]), heads=2)
    k2 = _k2_args(2, 4, 6, 128, 2, 6, device=cuda_device)
    with pytest.raises(ValueError, match="bias_x"):
        lane_axial_attention(**dict(k2, bias_x=k2["bias_y"]), heads=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 5, 32, 32, 384), (8, 5, 32, 32, 384), (2, 3, 8, 16, 128)],
                         ids=["slice", "training", "small"])
def test_k1_backward_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    heads = shape[-1] // 64
    args = _k1_args(shape, heads, 7, dtype, cuda_device)
    do = torch.randn(shape, generator=torch.Generator().manual_seed(8)).to(cuda_device, dtype)
    params = list(args.values())[1:]
    _, residuals = mega_temporal_block_fwd(args["x"], *params, heads=heads)
    before = mega_temporal_block_bwd.launches
    got = mega_temporal_block_bwd(do, args["x"], *params, heads=heads, residuals=residuals)
    assert mega_temporal_block_bwd.launches == before + 1
    want = temporal_branch_bwd_plain(do, **args, heads=heads)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and all(torch.isfinite(g.float()).all() for g in got)
    check_grads(list(args), [g.cpu() for g in got], [w.float().cpu().numpy() for w in want],
                TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("grid,c", K2_CASES, ids=K2_IDS)
def test_k2_backward_kernel_matches_plain_on_card(cuda_device, grid, c, dtype):
    bt, h, w = grid
    heads = c // 64
    args = _k2_args(bt, h, w, c, heads, 9, dtype, cuda_device)
    do = torch.randn(bt, h, w, c, generator=torch.Generator().manual_seed(10))
    do = do.to(cuda_device, dtype)
    before = lane_axial_attention_bwd.launches
    got = lane_axial_attention_bwd(do, *args.values(), heads=heads)
    assert lane_axial_attention_bwd.launches == before + 1
    want = axial_attention_bwd_plain(do, **args, heads=heads)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and all(torch.isfinite(g.float()).all() for g in got)
    check_grads(list(args), [g.cpu() for g in got], [w.float().cpu().numpy() for w in want],
                TOL[dtype])


@pytest.mark.cuda
def test_autograd_functions_launch_both_kernels_on_card(cuda_device):
    k1 = {k: v.requires_grad_() for k, v in _k1_args((1, 3, 8, 16, 128), 2, 11,
                                                      device=cuda_device).items()}
    k2 = {k: v.requires_grad_() for k, v in _k2_args(2, 8, 16, 128, 2, 12,
                                                     device=cuda_device).items()}
    counts = (mega_temporal_block.launches, mega_temporal_block_bwd.launches,
              lane_axial_attention.launches, lane_axial_attention_bwd.launches)
    loss = mega_temporal_block(**k1, heads=2).square().sum()
    loss = loss + lane_axial_attention(**k2, heads=2).square().sum()
    loss.backward()
    torch.cuda.synchronize()
    assert (mega_temporal_block.launches, mega_temporal_block_bwd.launches,
            lane_axial_attention.launches, lane_axial_attention_bwd.launches) == tuple(
                n + 1 for n in counts)
    assert all(torch.isfinite(v.grad).all() for v in [*k1.values(), *k2.values()])


@pytest.mark.cuda
def test_k3_autograd_function_launches_both_kernels_on_card(cuda_device):
    """Forward and backward through ``core_temporal_attention`` launch one
    kernel each; the autograd node keeps the arguments alone (no qkv: the
    backward kernel projects again)."""
    args = {k: v.requires_grad_() for k, v in _k3_args((1, 3, 8, 16, 128), 2, 17,
                                                        device=cuda_device).items()}
    saved = []
    counts = (core_temporal_attention.launches, core_temporal_attention_bwd.launches)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                  lambda t: t):
        out = core_temporal_attention(**args, heads=2)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (core_temporal_attention.launches,
            core_temporal_attention_bwd.launches) == (counts[0] + 1, counts[1] + 1)
    assert sorted(saved) == sorted(v.shape for v in args.values())
    assert all(torch.isfinite(v.grad).all() for v in args.values())


# The line kernels beyond one 64-token tile and at head dim 16: the 32x128
# flow-boiling grid at the rollout's and the training step's batch, lines of
# 512 tokens both ways, ragged last tiles (100 = 64 + 36, 72 = 64 + 8), and
# AViT-tiny's 6 heads of 16 at 64x64 tokens; for K4 also its own paths'
# shapes: FiLMAViT-small's grid at batch 1 and 8, 24x24 tokens (384^2 px at
# patch 16), h != w, and the make-demo grid (8x8 tokens, 6 heads of 16).
LONG_CASES = [((5, 32, 128), 384, 6), ((20, 32, 128), 384, 6), ((1, 16, 512), 384, 6),
              ((1, 512, 16), 384, 6), ((2, 100, 72), 128, 2), ((5, 64, 64), 96, 6)]
LONG_IDS = ["flow", "flow_training", "row_512", "col_512", "ragged", "d16"]
K4_CASES = [((5, 32, 32), 384, 6), ((40, 32, 32), 384, 6), ((5, 24, 24), 384, 6),
            ((2, 16, 40), 384, 6), ((10, 8, 8), 96, 6)] + LONG_CASES[:1] + LONG_CASES[2:]
K4_IDS = ["slice", "training", "grid_24", "wide", "demo_d16", "flow", "row_512", "col_512",
          "ragged", "d16"]
FLAVOURS = {
    "lane": (lane_axial_attention, lane_axial_attention_bwd, axial_attention_plain,
             axial_attention_bwd_plain),
    "fused_block": (fused_block_attention, fused_block_attention_bwd, fused_block_plain,
                    fused_block_bwd_plain),
}


def _line_case(flavour, grid, c, heads, dtype, device, seed):
    fwd, bwd, plain, bwd_plain = FLAVOURS[flavour]
    args = _k2_args(*grid, c, heads, seed, dtype, device)
    do = torch.randn(*grid, c, generator=torch.Generator().manual_seed(seed + 1))
    return fwd, bwd, plain, bwd_plain, args, do.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("flavour,grid,c,heads", [("lane", *k) for k in LONG_CASES]
                         + [("fused_block", *k) for k in K4_CASES],
                         ids=[f"lane-{i}" for i in LONG_IDS] + [f"k4-{i}" for i in K4_IDS])
def test_line_kernels_match_plain_on_card(cuda_device, flavour, grid, c, heads, dtype):
    """K2 on long lines and at head dim 16, and K4 at its paths' shapes:
    forward and every gradient against the plain versions."""
    fwd, bwd, plain, bwd_plain, args, do = _line_case(flavour, grid, c, heads, dtype,
                                                      cuda_device, 18)
    before = (fwd.launches, bwd.launches)
    got = fwd(**args, heads=heads)
    grads = bwd(do, *args.values(), heads=heads)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and grads[0].dtype == dtype
    _close(got, plain(**args, heads=heads), dtype)
    want = bwd_plain(do, **args, heads=heads)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g.float()).all() for g in grads)
    check_grads(list(args), [g.cpu() for g in grads], [w.float().cpu().numpy() for w in want],
                TOL[dtype])


@pytest.mark.cuda
def test_k4_autograd_function_launches_both_kernels_on_card(cuda_device):
    args = {k: v.requires_grad_() for k, v in _k2_args(2, 8, 8, 96, 6, 19,
                                                       device=cuda_device).items()}
    counts = (fused_block_attention.launches, fused_block_attention_bwd.launches)
    fused_block_attention(**args, heads=6).square().sum().backward()
    torch.cuda.synchronize()
    assert (fused_block_attention.launches,
            fused_block_attention_bwd.launches) == (counts[0] + 1, counts[1] + 1)
    assert all(torch.isfinite(v.grad).all() for v in args.values())


@pytest.mark.cuda
def test_line_kernels_raise_outside_their_envelope_on_card(cuda_device):
    args = _k2_args(2, 8, 8, 64, 2, 20, device=cuda_device)  # head dim 32
    with pytest.raises(ValueError, match=r"\(2, 8, 8, 192\)"):
        fused_block_attention(**args, heads=2)
    with pytest.raises(ValueError, match=r"\(2, 8, 8, 192\)"):
        lane_axial_attention(**args, heads=2)


def _k5_args(bt, h, w, c, heads, seed, dtype=torch.float32, device="cpu"):
    k1 = _k1_args((1, 1, 1, 1, c), heads, seed)
    rng = np.random.default_rng(seed + 1)

    def n(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    args = dict(x=n(bt, h, w, c).to(dtype),
                **{k: k1[k] for k in axial_block_mega.PARAM_NAMES[:12]},
                bias_x=n(heads, w, w), bias_y=n(heads, h, h),
                scale_x=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)),
                scale_y=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)))
    return {k: v.to(device) for k, v in args.items()}


def _split_args(bt, h, w, heads, d, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)

    def n(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    args = dict(q=n(bt, h, w, heads, d).to(dtype), k=n(bt, h, w, heads, d).to(dtype),
                v=n(bt, h, w, heads, d).to(dtype), bias_x=n(heads, w, w), bias_y=n(heads, h, h),
                scale_x=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)),
                scale_y=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)))
    return {k: v.to(device) for k, v in args.items()}


@pytest.mark.parametrize("shape,heads,why", [
    ((1, 3, 8, 16, 64), 2, "head_dim in"),   # d = 32
    ((1, 3, 8, 16, 64), 4, "a multiple of 3"),  # 4 heads of 16: not whole groups of three
    ((1, 9, 8, 16, 128), 2, "T <= 8"),
], ids=["head_dim_32", "heads_4_of_16", "t9"])
def test_temporal_kernels_reject_shapes_outside_their_envelope(shape, heads, why):
    """K1's and K3's envelope (head dim 16 in whole groups of three heads, or
    64; T <= 8) is checked before any launch; a miss names the shape.  Six
    heads of 16, AViT-tiny's, are inside."""
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match=why) as err:
        temporal_block_mega._check_kernel_shapes("mega_temporal_block", x, heads)
    assert str(tuple(shape)) in str(err.value)
    assert temporal_block_mega._check_kernel_shapes("k", torch.zeros(1, 5, 8, 16, 96), 6) == 16


@pytest.mark.parametrize("shape,heads,why", [
    ((2, 8, 8, 64), 2, "head_dim in"),     # d = 32
    ((1, 8, 600, 128), 2, "at most 512"),  # a row of 600 tokens
    ((2, 8, 8, 48), 3, "C % 32"),          # 3 heads of 16: C = 48
], ids=["head_dim_32", "line_600", "c48"])
def test_k5_rejects_shapes_outside_its_envelope(shape, heads, why):
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match=why) as err:
        axial_block_mega._check_kernel_shapes("mega_axial_block", x, heads)
    assert str(tuple(shape)) in str(err.value)


def test_new_wrappers_raise_on_other_devices():
    k5 = {k: v.to("meta") for k, v in _k5_args(2, 4, 6, 32, 2, 0).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        mega_axial_block(**k5, heads=2)
    split = {k: v.to("meta") for k, v in _split_args(2, 4, 6, 2, 16, 1).items()}
    for fn in (fused_axial_attention_packed, fused_axial_attention):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(**split)


# K5 on path C (FiLMAViT-small's grid at batch 1 and 8), at head dim 16
# (AViT-tiny's 512x512 grid), on the 32x128 flow-boiling grid (rows of 128)
# and a small ragged one.
K5_CASES = [((5, 32, 32), 384, 6), ((40, 32, 32), 384, 6), ((8, 64, 64), 96, 6),
            ((2, 32, 128), 384, 6), ((2, 12, 72), 128, 2)]
K5_IDS = ["slice", "training", "d16", "flow", "ragged"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("grid,c,heads", K5_CASES, ids=K5_IDS)
def test_k5_kernels_match_plain_on_card(cuda_device, grid, c, heads, dtype):
    """K5 forward and every gradient against the plain versions; one launch
    of each wrapper.  In bfloat16 the k-LayerNorm bias's gradient, zero up
    to rounding, is held to the plain version's own rounding noise
    (``check_grads``'s ``zero_noise``)."""
    args = _k5_args(*grid, c, heads, 21, dtype, cuda_device)
    do = torch.randn(*grid, c, generator=torch.Generator().manual_seed(22)).to(cuda_device, dtype)
    params = list(args.values())[1:]
    before = (mega_axial_block.launches, mega_axial_block_bwd.launches)
    got, residuals = mega_axial_block_fwd(args["x"], *params, heads=heads)
    grads = mega_axial_block_bwd(do, args["x"], *params, heads=heads, residuals=residuals)
    assert (mega_axial_block.launches, mega_axial_block_bwd.launches) == (before[0] + 1,
                                                                           before[1] + 1)
    assert got.dtype == dtype and grads[0].dtype == dtype
    _close(got, mega_axial_plain(**args, heads=heads), dtype)
    want = mega_axial_bwd_plain(do, **args, heads=heads)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g.float()).all() for g in grads)
    check_grads(list(args), [g.cpu() for g in grads], [w.float().cpu().numpy() for w in want],
                TOL[dtype], zero_noise=dtype == torch.bfloat16)


# K6 and K7 on path D (AViT-small's grid at batch 8), at head dim 16, on
# rows of 128 and a ragged grid.
SPLIT_CASES = [((40, 32, 32), 6, 64), ((5, 64, 64), 6, 16), ((2, 32, 128), 6, 64),
               ((2, 100, 72), 2, 64)]
SPLIT_IDS = ["training", "d16", "flow", "ragged"]
SPLIT_KERNELS = {
    "k6": (fused_axial_attention_packed, fused_axial_attention_packed_bwd, fused_packed_plain,
           fused_packed_bwd_plain),
    "k7": (fused_axial_attention, fused_axial_attention_bwd, fused_plain, fused_bwd_plain),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("grid,heads,d", SPLIT_CASES, ids=SPLIT_IDS)
@pytest.mark.parametrize("kernel", list(SPLIT_KERNELS))
def test_k6_k7_kernels_match_plain_on_card(cuda_device, kernel, grid, heads, d, dtype):
    fwd, bwd, plain, bwd_plain = SPLIT_KERNELS[kernel]
    args = _split_args(*grid, heads, d, 23, dtype, cuda_device)
    do = torch.randn(*grid, heads, d, generator=torch.Generator().manual_seed(24))
    do = do.to(cuda_device, dtype)
    before = (fwd.launches, bwd.launches)
    got = fwd(**args)
    grads = bwd(do, *args.values())
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and all(g.dtype == dtype for g in grads[:3])
    _close(got, plain(**args), dtype)
    want = bwd_plain(do, **args)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g.float()).all() for g in grads)
    check_grads(list(args), [g.cpu() for g in grads], [w.float().cpu().numpy() for w in want],
                TOL[dtype])


# K1 at head dim 16 (AViT-tiny at 512x512: 64x64 tokens, at batch 1 and 8)
# and K3 (its 512x2048 frames: 64x256 tokens), and small ones.
D16_CASES = [("k1", (1, 5, 64, 64, 96)), ("k1", (8, 5, 64, 64, 96)), ("k1", (2, 3, 8, 16, 96)),
             ("k3", (1, 5, 64, 256, 96)), ("k3", (2, 3, 8, 16, 192))]
D16_IDS = ["k1_slice", "k1_training", "k1_small", "k3_flow", "k3_small_12_heads"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel,shape", D16_CASES, ids=D16_IDS)
def test_k1_k3_at_head_dim_16_match_plain_on_card(cuda_device, kernel, shape, dtype):
    heads = shape[-1] // 16
    m = temporal_block_mega
    if kernel == "k1":
        args = _k1_args(shape, heads, 25, dtype, cuda_device)
        fwd, bwd, plain, bwd_plain = (m.mega_temporal_block_fwd, m.mega_temporal_block_bwd,
                                      m.temporal_branch_plain, m.temporal_branch_bwd_plain)
    else:
        args = _k3_args(shape, heads, 25, dtype, cuda_device)
        fwd, bwd, plain, bwd_plain = (m.core_temporal_attention_fwd,
                                      m.core_temporal_attention_bwd, m.core_temporal_plain,
                                      m.core_temporal_bwd_plain)
    do = torch.randn(shape, generator=torch.Generator().manual_seed(26)).to(cuda_device, dtype)
    act, params = args[next(iter(args))], list(args.values())[1:]
    if kernel == "k1":
        got, res = fwd(act, *params, heads=heads)
        grads = bwd(do, act, *params, heads=heads, residuals=res)
    else:
        got, grads = fwd(act, *params, heads=heads), bwd(do, act, *params, heads=heads)
    _close(got, plain(**args, heads=heads), dtype)
    want = bwd_plain(do, **args, heads=heads)
    torch.cuda.synchronize()
    assert grads[0].dtype == dtype and all(torch.isfinite(g.float()).all() for g in grads)
    check_grads(list(args), [g.cpu() for g in grads], [w.float().cpu().numpy() for w in want],
                TOL[dtype])


@pytest.mark.cuda
def test_new_autograd_functions_launch_both_kernels_on_card(cuda_device):
    """Forward and backward through ``mega_axial_block``,
    ``fused_axial_attention_packed`` and ``fused_axial_attention`` launch
    one kernel each."""
    k5 = {k: v.requires_grad_() for k, v in _k5_args(2, 8, 8, 96, 6, 27,
                                                      device=cuda_device).items()}
    counts = (mega_axial_block.launches, mega_axial_block_bwd.launches)
    mega_axial_block(**k5, heads=6).square().sum().backward()
    torch.cuda.synchronize()
    assert (mega_axial_block.launches, mega_axial_block_bwd.launches) == (counts[0] + 1,
                                                                           counts[1] + 1)
    assert all(torch.isfinite(v.grad).all() for v in k5.values())
    for fwd, bwd, _, _ in SPLIT_KERNELS.values():
        args = {k: v.requires_grad_() for k, v in _split_args(2, 8, 8, 6, 16, 28,
                                                               device=cuda_device).items()}
        counts = (fwd.launches, bwd.launches)
        fwd(**args).square().sum().backward()
        torch.cuda.synchronize()
        assert (fwd.launches, bwd.launches) == (counts[0] + 1, counts[1] + 1)
        assert all(torch.isfinite(v.grad).all() for v in args.values())


@pytest.mark.cuda
def test_new_kernels_raise_outside_their_envelope_on_card(cuda_device):
    """Head dim 32 is outside every kernel; K1 at four heads of 16 is not
    whole groups of three."""
    k5 = _k5_args(2, 8, 8, 64, 2, 29, device=cuda_device)
    with pytest.raises(ValueError, match=r"\(2, 8, 8, 64\)"):
        mega_axial_block(**k5, heads=2)
    split = _split_args(2, 8, 8, 2, 32, 30, device=cuda_device)
    for fn in (fused_axial_attention_packed, fused_axial_attention):
        with pytest.raises(ValueError, match=r"\(2, 8, 8, 2, 32\)"):
            fn(**split)
    k1 = _k1_args((1, 3, 8, 16, 64), 4, 31, device=cuda_device)
    with pytest.raises(ValueError, match=r"\(1, 3, 8, 16, 64\)"):
        mega_temporal_block(**k1, heads=4)


def _flash_args(shape, seed, dtype=torch.float32, device="cpu"):
    heads, _, n, _ = shape
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32))

    args = dict(q=t(rng.standard_normal(shape)).to(dtype),
                k=t(rng.standard_normal(shape)).to(dtype),
                v=t(rng.standard_normal(shape)).to(dtype),
                bias=t(rng.standard_normal((heads, n, n))),
                scale_factor=t(rng.uniform(0.5, 1.5, heads)))
    return {k: v.to(device) for k, v in args.items()}


def _loss_args(shape, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    pred, tgt = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
    return pred.to(device, dtype), tgt.to(device)


def test_k8_k10_wrappers_take_plain_versions_on_cpu():
    """K8's and K10's wrappers on CPU tensors: the plain versions, forward
    and backward, and no launch counted."""
    args = {k: v.requires_grad_() for k, v in _flash_args((2, 6, 5, 16), 40).items()}
    pred, tgt = _loss_args((2, 5, 4, 8, 8), 41)
    pred.requires_grad_()
    counts = (flash_packed_attention.launches, flash_packed_attention_bwd.launches,
              plane_norms.launches, plane_norms_bwd.launches)
    out = flash_packed_attention(**args)
    torch.testing.assert_close(out, flash_plain(**args), rtol=0, atol=0)
    out.square().sum().backward()
    loss = training_lp_loss(pred, tgt)
    loss.backward()
    assert (flash_packed_attention.launches, flash_packed_attention_bwd.launches,
            plane_norms.launches, plane_norms_bwd.launches) == counts
    want = flash_bwd_plain(2 * out.detach(), *(a.detach() for a in args.values()))
    for (name, a), w in zip(args.items(), want):
        torch.testing.assert_close(a.grad, w, rtol=0, atol=0, msg=name)
    assert torch.isfinite(pred.grad).all()


def test_k8_k10_wrappers_raise_on_other_devices():
    args = {k: v.to("meta") for k, v in _flash_args((2, 6, 5, 16), 42).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        flash_packed_attention(**args)
    pred, tgt = (a.to("meta") for a in _loss_args((1, 2, 2, 4, 4), 43))
    with pytest.raises(ValueError, match="unsupported device"):
        training_lp_loss(pred, tgt)


# K8 on path F (FiLMAViT-small at 512^2: the temporal lines (6, B*1024, 5,
# 64) and the axial rows and columns (6, B*5*32, 32, 64), at B = 1 and 8),
# at head dim 16, on lines of 64 and past one 64-token tile, and a ragged one.
K8_CASES = [(6, 1024, 5, 64), (6, 8192, 5, 64), (6, 160, 32, 64), (6, 1280, 32, 64),
            (6, 640, 5, 16), (6, 40, 32, 16), (2, 24, 64, 64), (2, 12, 200, 64), (3, 7, 77, 16)]
K8_IDS = ["t_slice", "t_training", "ax_slice", "ax_training", "t_d16", "ax_d16", "l64", "l200",
          "ragged"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", K8_CASES, ids=K8_IDS)
def test_k8_kernels_match_plain_on_card(cuda_device, shape, dtype):
    args = _flash_args(shape, 44, dtype, cuda_device)
    do = torch.randn(shape, generator=torch.Generator().manual_seed(45)).to(cuda_device, dtype)
    before = (flash_packed_attention.launches, flash_packed_attention_bwd.launches)
    got = flash_packed_attention(**args)
    grads = flash_packed_attention_bwd(do, *args.values())
    assert (flash_packed_attention.launches, flash_packed_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and all(g.dtype == dtype for g in grads[:3])
    _close(got, flash_plain(**args), dtype)
    want = flash_bwd_plain(do, **args)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g.float()).all() for g in grads)
    check_grads(list(args), [g.cpu() for g in grads], [w.float().cpu().numpy() for w in want],
                TOL[dtype])


@pytest.mark.cuda
def test_k8_autograd_function_launches_both_kernels_on_card(cuda_device):
    args = {k: v.requires_grad_() for k, v in _flash_args((2, 16, 5, 64), 46,
                                                           device=cuda_device).items()}
    counts = (flash_packed_attention.launches, flash_packed_attention_bwd.launches)
    flash_packed_attention(**args).square().sum().backward()
    torch.cuda.synchronize()
    assert (flash_packed_attention.launches, flash_packed_attention_bwd.launches) == (
        counts[0] + 1, counts[1] + 1)
    assert all(torch.isfinite(v.grad).all() for v in args.values())


@pytest.mark.cuda
def test_k8_raises_outside_its_envelope_on_card(cuda_device):
    """Head dim 32 and lines of 513 tokens are outside K8."""
    for shape in ((2, 4, 5, 32), (1, 2, 513, 16)):
        args = _flash_args(shape, 47, device=cuda_device)
        with pytest.raises(ValueError, match=re.escape(str(tuple(shape)))):
            flash_packed_attention(**args)


# K10 at path F's bf16 step (pred (8, 5, 4, 512, 512) in bf16 against the
# float32 target), in float32, and a ragged plane (n % 4 != 0).
K10_CASES = [((8, 5, 4, 512, 512), torch.bfloat16), ((8, 5, 4, 512, 512), torch.float32),
             ((2, 3, 4, 33, 35), torch.bfloat16), ((2, 3, 4, 33, 35), torch.float32)]
K10_IDS = ["step_bf16", "step_f32", "ragged_bf16", "ragged_f32"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", K10_CASES, ids=K10_IDS)
def test_k10_kernels_match_plain_on_card(cuda_device, shape, dtype):
    """The plane sums 1e-5 of each column's largest (float32 sums in another
    order), the gradient as the other kernels' (it rounds once); the loss
    repeats bit for bit (no atomics)."""
    pred, tgt = _loss_args(shape, 48, dtype, cuda_device)
    m = pred.shape[0] * pred.shape[1] * pred.shape[2]
    p3, t3 = pred.reshape(m, -1), tgt.reshape(m, -1)
    coef = torch.rand(m, generator=torch.Generator().manual_seed(49)).to(cuda_device)
    before = (plane_norms.launches, plane_norms_bwd.launches)
    out = plane_norms(p3, t3)
    dpred = plane_norms_bwd(p3, t3, coef)
    assert (plane_norms.launches, plane_norms_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = plane_norms_plain(p3, t3)
    err = ((out - want).abs().max(dim=0).values / want.abs().max(dim=0).values).max()
    assert err <= 1e-5, float(err)
    assert dpred.dtype == dtype
    _close(dpred, plane_norms_bwd_plain(p3, t3, coef), dtype)
    assert torch.equal(training_lp_loss(pred, tgt), training_lp_loss(pred, tgt))


def _px_args(shape, heads, seed, dtype=torch.float32, device="cpu"):
    """K9's arguments for x of ``shape`` (BT, H, W, C): x in ``dtype``, the
    rest float32."""
    bt, h, w, c = shape
    rng = np.random.default_rng(seed)
    d = c // heads

    def n(*s, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(s)).astype(np.float32))

    args = dict(
        x=n(*shape).to(dtype), wqkv=n(3 * c, c, scale=c**-0.5), bqkv=n(3 * c, scale=0.2),
        qn_scale=n(d, scale=0.2, offset=1.0), qn_bias=n(d, scale=0.2),
        kn_scale=n(d, scale=0.2, offset=1.0), kn_bias=n(d, scale=0.2),
        bias_x=n(heads, w, w), bias_y=n(heads, h, h),
        scale_x=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)),
        scale_y=torch.from_numpy(rng.uniform(0.5, 1.5, heads).astype(np.float32)),
    )
    return {k: v.to(device) for k, v in args.items()}


def test_k9_wrappers_take_plain_versions_on_cpu():
    args = _px_args((2, 8, 16, 64), 4, 50)
    do = torch.randn(2, 8, 16, 64, generator=torch.Generator().manual_seed(51))
    before = (lane_px_attention.launches, lane_px_attention_bwd.launches)
    torch.testing.assert_close(lane_px_attention(**args, heads=4),
                               lane_px_plain(**args, heads=4), rtol=0, atol=0)
    for g, w in zip(lane_px_attention_bwd(do, *args.values(), heads=4),
                    lane_px_bwd_plain(do, **args, heads=4)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (lane_px_attention.launches, lane_px_attention_bwd.launches) == before


# K9 at FiLMAViT-small's rollout and training shapes (6 heads of 64), the
# flow-boiling 32x128 grid at batch 4, AViT-tiny's 64x64 grid at 512x512
# (6 heads of 16), and a small one.
K9_CASES = [((5, 32, 32, 384), 6), ((40, 32, 32, 384), 6), ((20, 32, 128, 384), 6),
            ((40, 64, 64, 96), 6), ((2, 8, 16, 64), 4)]
K9_IDS = ["slice", "training", "flow_b4", "tiny_d16", "small"]
# chip_smoke.py's LINE_RTOL: float32 against the plain version in float64
# (the kernels' own float32 error), bfloat16 against the plain version in
# bfloat16, the same rounding points.  In bfloat16 the card's and the plain
# version's projections sum in other orders, so their qkv differ by single
# ulps before the line kernels' own flips, and the k-LayerNorm bias's
# gradient, zero up to rounding, is independent noise on each side (on an
# H100 it read 1.6e-2 of the floor at the training shape): it is held to the
# plain version's own noise (check_grads' zero_noise), as K5's is.
K9_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,heads", K9_CASES, ids=K9_IDS)
def test_k9_kernels_match_plain_on_card(cuda_device, shape, heads, dtype):
    """Forward and every gradient (x, W, b, the qk-LN vectors, both tables,
    both scales); dW unrounded in bfloat16, as the plain version's."""
    args = _px_args(shape, heads, 52, dtype, cuda_device)
    do = torch.randn(*shape, generator=torch.Generator().manual_seed(53)).to(cuda_device, dtype)
    ref_args, ref_do = ((args, do) if dtype == torch.bfloat16 else
                        ({k: v.double() for k, v in args.items()}, do.double()))
    before = (lane_px_attention.launches, lane_px_attention_bwd.launches)
    got = lane_px_attention(**args, heads=heads)
    grads = lane_px_attention_bwd(do, *args.values(), heads=heads)
    assert (lane_px_attention.launches, lane_px_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and grads[0].dtype == dtype and grads[1].dtype == torch.float32
    want = lane_px_plain(**ref_args, heads=heads)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    err = (got.double() - want.double()).abs().max().item()
    assert err <= K9_TOL[dtype] * want.double().abs().max().item(), err
    want = lane_px_bwd_plain(ref_do, **ref_args, heads=heads)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g.float()).all() for g in grads)
    check_grads(list(args), [g.cpu() for g in grads], [w.double().cpu().numpy() for w in want],
                K9_TOL[dtype], zero_noise=dtype == torch.bfloat16)
    if dtype == torch.bfloat16:
        assert not torch.equal(grads[1], grads[1].bfloat16().float())


@pytest.mark.cuda
def test_k9_autograd_function_keeps_no_qkv_and_launches_both_kernels_on_card(cuda_device):
    """The autograd node keeps the arguments alone (nothing 3C wide) and
    the backward launches K9's backward once."""
    args = {k: v.requires_grad_() for k, v in _px_args((2, 8, 16, 64), 4, 54,
                                                       device=cuda_device).items()}
    saved = []
    counts = (lane_px_attention.launches, lane_px_attention_bwd.launches)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                  lambda t: t):
        out = lane_px_attention(**args, heads=4)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (lane_px_attention.launches, lane_px_attention_bwd.launches) == (
        counts[0] + 1, counts[1] + 1)
    assert sorted(saved) == sorted(v.shape for v in args.values())
    assert all(torch.isfinite(v.grad).all() for v in args.values())


@pytest.mark.cuda
def test_k9_raises_outside_its_envelope_on_card(cuda_device):
    """Head dim 32, lines of 513 tokens and C = 48 (not a multiple of the
    GEMM tile's 32) are outside K9."""
    for shape, heads in (((1, 4, 8, 128), 4), ((1, 1, 513, 64), 4), ((1, 4, 8, 48), 3)):
        args = _px_args(shape, heads, 55, device=cuda_device)
        with pytest.raises(ValueError, match=re.escape(str(tuple(shape)))):
            lane_px_attention(**args, heads=heads)
