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
sums are also reordered by atomics from run to run (but K1's bf16 weight
gradients, split-K sums added in a fixed order, repeat bit for bit, and so
do K3's bf16 dW_qkv and K2's bf16 table, scale and qk-LN gradients, which
its Hopper kernels sum from per-block partials in a fixed order; those are
also held to chip_smoke.py's 1e-2 at every K2 shape, long lines and head
dim 16 included).  The Hopper GEMM of K1's and K3's products, in both
operand layouts and with each epilogue, is held against ``torch.matmul`` in
float32 at their shapes and ragged ones.
"""
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.ops import axial_block_mega, hopper_gemm, temporal_block_mega
from bubbleformer_tpu_torch.ops.axial_block_mega import (
    mega_axial_block,
    mega_axial_block_bwd,
    mega_axial_block_fwd,
    mega_axial_bwd_plain,
    mega_axial_plain,
    mega_hopper_bwd,
    mega_hopper_fwd,
    mega_kernels,
    mega_line_bwd,
    mega_line_fwd,
)
from bubbleformer_tpu_torch.ops.axial_fused import (
    fused_axial_attention,
    fused_axial_attention_bwd,
    fused_bwd_plain,
    fused_hopper_bwd,
    fused_hopper_fwd,
    fused_kernels,
    fused_line_bwd,
    fused_line_fwd,
    fused_plain,
)
from bubbleformer_tpu_torch.ops.axial_fused_block import (
    fused_block_attention,
    fused_block_attention_bwd,
    fused_block_bwd_plain,
    fused_block_hopper_bwd,
    fused_block_hopper_fwd,
    fused_block_line_bwd,
    fused_block_line_fwd,
    fused_block_plain,
)
from bubbleformer_tpu_torch.ops.axial_fused_packed import (
    fused_axial_attention_packed,
    fused_axial_attention_packed_bwd,
    fused_packed_bwd_plain,
    fused_packed_hopper_bwd,
    fused_packed_hopper_fwd,
    fused_packed_kernels,
    fused_packed_line_bwd,
    fused_packed_line_fwd,
    fused_packed_plain,
)
from bubbleformer_tpu_torch.ops.axial_lane import (
    axial_attention_bwd_plain,
    axial_attention_plain,
    kernel_params,
    lane_axial_attention,
    lane_axial_attention_bwd,
    lane_bwd_plan,
    lane_hopper_bwd,
    lane_hopper_fwd,
    lane_kernels,
    lane_line_bwd,
    lane_line_fwd,
)
from bubbleformer_tpu_torch.ops.axial_lane_px import (
    lane_px_attention,
    lane_px_attention_bwd,
    lane_px_bwd_plain,
    lane_px_plain,
    px_hopper_bwd,
    px_hopper_fwd,
    px_kernels,
    px_line_bwd,
    px_line_fwd,
)
from bubbleformer_tpu_torch.ops.axial_pallas import (
    flash_bwd_plain,
    flash_hopper_bwd,
    flash_hopper_fwd,
    flash_line_bwd,
    flash_line_fwd,
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
from bubbleformer_tpu_torch.probes import chunk_axial, lane_axial, mosaic, pyramid
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


def _c_entries():
    """Each C entry of ``csrc/*.cu``: its name and its parameters' kinds
    (``P`` a pointer, ``L`` a long long, ``F`` a float, ``I`` an int)."""
    entries = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = re.sub(r"//.*", "", src.read_text())
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            kinds = []
            for p in (p.strip() for p in params.split(",") if p.strip()):
                kinds.append("P" if "*" in p else "L" if "long long" in p else
                             "F" if p.startswith("float") else "I")
            entries[name] = kinds
    return entries


def test_c_signatures_match_the_c_entries():
    """Every C signature the library is loaded with (``_build._SIGNATURES``)
    has its C entry's parameters, one for one: a missing or extra one would
    shift every argument after it."""
    import ctypes

    kinds = {_build._P: "P", _build._LP: "P", _build._IP: "P", _build._FP: "P",
             _build._L: "L", _build._F: "F", _build._I: "I"}
    entries = _c_entries()
    for name, argtypes in _build._SIGNATURES.items():
        assert name in entries, name
        assert [kinds[t] for t in argtypes] == entries[name], name
    assert ctypes.sizeof(ctypes.c_longlong) == 8


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


def test_k2_kernels_are_chosen_by_dtype():
    """bfloat16 takes the Hopper kernels, float32 the line kernels; any other
    dtype has no kernel."""
    assert lane_kernels(torch.bfloat16) == (lane_hopper_fwd, lane_hopper_bwd)
    assert lane_kernels(torch.float32) == (lane_line_fwd, lane_line_bwd)
    with pytest.raises(TypeError, match="float16"):
        lane_kernels(torch.float16)


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_k2_line_kernels_take_float32_alone(kernel):
    """The line kernels' lane flavour is built in float32 alone: a bfloat16
    call raises before it reaches a card, naming the Hopper kernels."""
    args = _k2_args(1, 4, 4, 32, 2, 21, dtype=torch.bfloat16)
    qkv, params = args.pop("qkv"), tuple(args.values())
    with pytest.raises(TypeError, match="lane_hopper"):
        if kernel == "fwd":
            lane_line_fwd(qkv, *params, heads=2)
        else:
            lane_line_bwd(torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16), qkv, *params, heads=2)


# (lines of a direction, heads, blocks resident on the card): FiLMAViT-small's
# rows (and columns) at the training and rollout batch, AViT-big's 12 heads,
# the flow-boiling grid's rows of 128 and columns of 32 at batch 4,
# AViT-tiny's rows of 256 at 512x2048, lines of 512, a few lines of 8, and a
# wave narrower than the heads.  Residents: 132 SMs times 1 to 8 blocks.
PLAN_CASES = [(1280, 6, 528), (160, 6, 528), (1280, 12, 528), (640, 6, 132), (2560, 6, 528),
              (1280, 6, 264), (16, 6, 132), (3, 6, 1056), (40, 6, 4)]


@pytest.mark.parametrize("lines,heads,resident", PLAN_CASES,
                         ids=["training", "rollout", "big", "flow_rows", "flow_cols", "d16_rows",
                              "rows_512", "three", "narrow"])
def test_k2_backward_plan_gives_every_line_to_one_block(lines, heads, resident):
    """Block g of a head takes lines g * per .. (g + 1) * per: every line
    once, no block without a line, at least one block a head and at most
    one wave of the resident blocks."""
    groups, per = lane_bwd_plan(lines, heads, resident)
    owned = [li for g in range(groups) for li in range(g * per, min((g + 1) * per, lines))]
    assert owned == list(range(lines))
    assert (groups - 1) * per < lines
    assert groups * heads <= max(resident, heads)
    if lines * heads >= 2 * resident:  # enough lines: the wave is mostly filled
        assert groups * heads >= resident // 2, (groups, per)


# K2's bfloat16 Hopper kernels (csrc/lane_hopper.cuh) at every K2_CASES shape,
# the flow-boiling 32x128 grid, lines of 512 both ways (the long-line
# backward), AViT-tiny's 6 heads of 16 at 64x64 and at 64x256 tokens (rows of
# 256), and ragged lines of 100 and 72: forward and every gradient against
# the plain versions in bfloat16, held to chip_smoke.py's LINE_RTOL (1e-2 of
# each output's or gradient's largest magnitude; single-ulp bf16 flips where
# reordered float32 sums straddle a rounding edge).
HOPPER_CASES = [(grid, c, c // 64) for grid, c in K2_CASES] + [
    ((4, 32, 128), 384, 6), ((1, 16, 512), 384, 6), ((1, 512, 16), 384, 6),
    ((5, 64, 64), 96, 6), ((2, 64, 256), 96, 6), ((2, 100, 72), 128, 2)]
HOPPER_IDS = K2_IDS + ["flow", "rows_512", "cols_512", "d16", "d16_rows_256", "ragged"]
LINE_RTOL_BF16 = 1e-2


def _hopper_counts():
    return (lane_hopper_fwd.launches, lane_hopper_bwd.launches, lane_line_fwd.launches,
            lane_line_bwd.launches, lane_axial_attention.launches,
            lane_axial_attention_bwd.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("grid,c,heads", HOPPER_CASES, ids=HOPPER_IDS)
def test_k2_hopper_kernels_match_plain_on_card(cuda_device, grid, c, heads):
    args = _k2_args(*grid, c, heads, 60, torch.bfloat16, cuda_device)
    do = torch.randn(*grid, c, generator=torch.Generator().manual_seed(61))
    do = do.to(cuda_device, torch.bfloat16)
    before = _hopper_counts()
    got = lane_axial_attention(**args, heads=heads)
    grads = lane_axial_attention_bwd(do, *args.values(), heads=heads)
    assert _hopper_counts() == tuple(n + k for n, k in zip(before, (1, 1, 0, 0, 1, 1)))
    assert got.dtype == torch.bfloat16 and grads[0].dtype == torch.bfloat16
    want = axial_attention_plain(**args, heads=heads)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= LINE_RTOL_BF16 * want.float().abs().max().item(), err
    want = axial_attention_bwd_plain(do, **args, heads=heads)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g.float()).all() for g in grads)
    check_grads(list(args), [g.cpu() for g in grads], [w.float().cpu().numpy() for w in want],
                LINE_RTOL_BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("grid,c,heads", [((40, 32, 32), 384, 6), ((4, 32, 128), 384, 6),
                                          ((1, 16, 512), 384, 6), ((2, 64, 256), 96, 6)],
                         ids=["training", "flow", "rows_512", "d16_rows_256"])
def test_k2_hopper_parameter_gradients_repeat_bit_for_bit_on_card(cuda_device, grid, c, heads):
    """The table, scale and qk-LN gradients are per-block partials added in
    a fixed order: two calls give the same bits (and so does dqkv)."""
    args = _k2_args(*grid, c, heads, 62, torch.bfloat16, cuda_device)
    do = torch.randn(*grid, c, generator=torch.Generator().manual_seed(63))
    do = do.to(cuda_device, torch.bfloat16)
    first = lane_axial_attention_bwd(do, *args.values(), heads=heads)
    first = [g.clone() for g in first]
    second = lane_axial_attention_bwd(do, *args.values(), heads=heads)
    torch.cuda.synchronize()
    for name, a, b in zip(args, first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_k2_float32_takes_the_line_kernels_on_card(cuda_device):
    """float32 stays on the line kernels: their counters move, the Hopper
    kernels' do not; a bfloat16 shape outside the envelope raises, naming
    it, with no kernel launched."""
    args = _k2_args(2, 8, 16, 128, 2, 64, device=cuda_device)
    do = torch.randn(2, 8, 16, 128, generator=torch.Generator().manual_seed(65)).to(cuda_device)
    before = _hopper_counts()
    lane_axial_attention(**args, heads=2)
    lane_axial_attention_bwd(do, *args.values(), heads=2)
    torch.cuda.synchronize()
    assert _hopper_counts() == tuple(n + k for n, k in zip(before, (0, 0, 1, 1, 1, 1)))
    bad = _k2_args(2, 8, 8, 64, 2, 66, torch.bfloat16, cuda_device)  # head dim 32
    before = _hopper_counts()
    with pytest.raises(ValueError, match=r"\(2, 8, 8, 192\)"):
        lane_axial_attention(**bad, heads=2)
    with pytest.raises(ValueError, match=r"\(2, 8, 8, 192\)"):
        lane_axial_attention_bwd(torch.zeros(2, 8, 8, 64, device=cuda_device,
                                             dtype=torch.bfloat16), *bad.values(), heads=2)
    assert _hopper_counts() == before


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
# (AViT-tiny's 512x512 grid, at batch 8 as chip_smoke.py's BRANCH_SHAPES and
# a smaller one), on the 32x128 flow-boiling grid (rows of 128), lines of
# 512 both ways (the bf16 attention's long-line backward) and a small ragged
# grid.
K5_CASES = [((5, 32, 32), 384, 6), ((40, 32, 32), 384, 6), ((8, 64, 64), 96, 6),
            ((40, 64, 64), 96, 6), ((2, 32, 128), 384, 6), ((1, 16, 512), 384, 6),
            ((1, 512, 16), 384, 6), ((2, 12, 72), 128, 2)]
K5_IDS = ["slice", "training", "d16", "d16_training", "flow", "rows_512", "cols_512", "ragged"]


def _k5_k9_counts():
    return (mega_hopper_fwd.launches, mega_hopper_bwd.launches, mega_line_fwd.launches,
            mega_line_bwd.launches, px_hopper_fwd.launches, px_hopper_bwd.launches,
            px_line_fwd.launches, px_line_bwd.launches)


def _path_step(kernel, dtype):
    """The counters a K5 or K9 forward and backward on the card moves: its
    dtype's chain (``_k5_k9_counts`` order), once each."""
    at = {("k5", torch.bfloat16): 0, ("k5", torch.float32): 2, ("k9", torch.bfloat16): 4,
          ("k9", torch.float32): 6}[kernel, dtype]
    return tuple(1 if i in (at, at + 1) else 0 for i in range(8))


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
    paths = _k5_k9_counts()
    got, residuals = mega_axial_block_fwd(args["x"], *params, heads=heads)
    grads = mega_axial_block_bwd(do, args["x"], *params, heads=heads, residuals=residuals)
    assert (mega_axial_block.launches, mega_axial_block_bwd.launches) == (before[0] + 1,
                                                                           before[1] + 1)
    assert _k5_k9_counts() == tuple(a + b for a, b in zip(paths, _path_step("k5", dtype)))
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


# K8's and K4's bf16 Hopper kernels (csrc/flash_hopper.cuh; lane_hopper.cuh
# in K4's rounding) where their packing and staging change: K8's lines of 5
# and 8 with M not a multiple of a segment's lines (24 and 16), lines of 13
# (one a tile), of 20, 40 and 64 (one or two a unit), of 100 (a unit of
# 128), of 300 at head dim 16 (the backward on the Hopper kernels) and at 64
# (its backward on the line kernels); K4 at the make-demo grid (8x8 tokens,
# head dim 16) and FiLMAViT-small's: forward and every gradient against the
# plain versions in bfloat16, held to chip_smoke.py's LINE_RTOL (1e-2), the
# launches counted on the path each takes.
K8_HOPPER_CASES = [(6, 1027, 5, 64), (2, 37, 8, 16), (2, 10, 13, 64), (2, 9, 20, 16),
                   (2, 5, 40, 64), (2, 6, 64, 16), (2, 3, 100, 64), (1, 2, 300, 16),
                   (1, 2, 300, 64)]
K8_HOPPER_IDS = ["t_ragged", "demo_ragged", "n13", "n20_d16", "n40", "n64_d16", "n100",
                 "n300_d16", "n300_line_bwd"]


def _flash_counts():
    return (flash_hopper_fwd.launches, flash_hopper_bwd.launches, flash_line_fwd.launches,
            flash_line_bwd.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K8_HOPPER_CASES, ids=K8_HOPPER_IDS)
def test_k8_hopper_kernels_match_plain_on_card(cuda_device, shape):
    args = _flash_args(shape, 48, torch.bfloat16, cuda_device)
    do = torch.randn(shape, generator=torch.Generator().manual_seed(49))
    do = do.to(cuda_device, torch.bfloat16)
    before = _flash_counts()
    got = flash_packed_attention(**args)
    grads = flash_packed_attention_bwd(do, *args.values())
    hopper_bwd = shape[2] <= 256 or shape[3] == 16
    assert _flash_counts() == tuple(a + b for a, b in zip(
        before, (1, int(hopper_bwd), 0, int(not hopper_bwd))))
    _close(got, flash_plain(**args), torch.bfloat16)
    want = flash_bwd_plain(do, **args)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g.float()).all() for g in grads)
    check_grads(list(args), [g.cpu() for g in grads], [w.float().cpu().numpy() for w in want],
                LINE_RTOL_BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("grid,c", [((10, 8, 8), 96), ((40, 32, 32), 384)],
                         ids=["demo_d16", "training"])
def test_k4_hopper_kernels_match_plain_on_card(cuda_device, grid, c):
    args = _k2_args(*grid, c, 6, 50, torch.bfloat16, cuda_device)
    do = torch.randn(*grid, c, generator=torch.Generator().manual_seed(51))
    do = do.to(cuda_device, torch.bfloat16)
    before = (fused_block_hopper_fwd.launches, fused_block_hopper_bwd.launches,
              fused_block_line_fwd.launches, fused_block_line_bwd.launches)
    got = fused_block_attention(**args, heads=6)
    grads = fused_block_attention_bwd(do, *args.values(), heads=6)
    assert (fused_block_hopper_fwd.launches, fused_block_hopper_bwd.launches,
            fused_block_line_fwd.launches, fused_block_line_bwd.launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    _close(got, fused_block_plain(**args, heads=6), torch.bfloat16)
    want = fused_block_bwd_plain(do, **args, heads=6)
    torch.cuda.synchronize()
    check_grads(list(args), [g.cpu() for g in grads], [w.float().cpu().numpy() for w in want],
                LINE_RTOL_BF16)


@pytest.mark.cuda
def test_k4_k8_float32_take_the_line_kernels_on_card(cuda_device):
    args = _k2_args(2, 8, 8, 96, 6, 52, torch.float32, cuda_device)
    before = (fused_block_line_fwd.launches, fused_block_line_bwd.launches)
    fused_block_attention_bwd(torch.ones(2, 8, 8, 96, device=cuda_device), *args.values(),
                              heads=6)
    fused_block_attention(**args, heads=6)
    flash = _flash_args((2, 6, 5, 16), 53, torch.float32, cuda_device)
    counts = _flash_counts()
    flash_packed_attention(**flash)
    flash_packed_attention_bwd(torch.ones(2, 6, 5, 16, device=cuda_device), *flash.values())
    torch.cuda.synchronize()
    assert (fused_block_line_fwd.launches, fused_block_line_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert _flash_counts() == (counts[0], counts[1], counts[2] + 1, counts[3] + 1)


# K6's and K7's bf16 Hopper kernels (csrc/lane_hopper.cuh's kFusedPacked;
# csrc/flash_hopper.cuh over rows and columns) at path D's training shape,
# AViT-tiny's head dim 16, the 32x128 flow-boiling grid at batch 4 and rows
# of 512 tokens (K7's backward there on the line kernels, chosen by shape):
# forward and every gradient against the plain versions in bfloat16, held
# to chip_smoke.py's LINE_RTOL (1e-2), the launches counted on the path
# each takes.
SPLIT_HOPPER_CASES = [((40, 32, 32), 6, 64), ((40, 64, 64), 6, 16), ((20, 32, 128), 6, 64),
                      ((2, 8, 512), 6, 64)]
SPLIT_HOPPER_IDS = ["training", "d16", "flow", "rows_512"]
SPLIT_PATHS = {"k6": (fused_packed_hopper_fwd, fused_packed_hopper_bwd, fused_packed_line_fwd,
                      fused_packed_line_bwd),
               "k7": (fused_hopper_fwd, fused_hopper_bwd, fused_line_fwd, fused_line_bwd)}


def _split_counts(kernel):
    return tuple(fn.launches for fn in SPLIT_PATHS[kernel])


@pytest.mark.cuda
@pytest.mark.parametrize("grid,heads,d", SPLIT_HOPPER_CASES, ids=SPLIT_HOPPER_IDS)
@pytest.mark.parametrize("kernel", list(SPLIT_KERNELS))
def test_k6_k7_hopper_kernels_match_plain_on_card(cuda_device, kernel, grid, heads, d):
    fwd, bwd, plain, bwd_plain = SPLIT_KERNELS[kernel]
    args = _split_args(*grid, heads, d, 84, torch.bfloat16, cuda_device)
    do = torch.randn(*grid, heads, d, generator=torch.Generator().manual_seed(85))
    do = do.to(cuda_device, torch.bfloat16)
    before = _split_counts(kernel)
    got = fwd(**args)
    grads = bwd(do, *args.values())
    hopper_bwd = kernel == "k6" or max(grid[1:]) <= 256 or d == 16
    assert _split_counts(kernel) == tuple(a + b for a, b in zip(
        before, (1, int(hopper_bwd), 0, int(not hopper_bwd))))
    _close(got, plain(**args), torch.bfloat16)
    want = bwd_plain(do, **args)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g.float()).all() for g in grads)
    check_grads(list(args), [g.cpu() for g in grads], [w.float().cpu().numpy() for w in want],
                LINE_RTOL_BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(SPLIT_KERNELS))
def test_k6_k7_float32_take_the_line_kernels_on_card(cuda_device, kernel):
    fwd, bwd, _, _ = SPLIT_KERNELS[kernel]
    args = _split_args(2, 8, 8, 6, 16, 86, torch.float32, cuda_device)
    before = _split_counts(kernel)
    fwd(**args)
    bwd(torch.ones(2, 8, 8, 6, 16, device=cuda_device), *args.values())
    torch.cuda.synchronize()
    assert _split_counts(kernel) == (before[0], before[1], before[2] + 1, before[3] + 1)


def _layer_views(bt, h, w, heads, d, seed, device):
    """q, k and v as the block hands them to K6 and K7: contiguous q and k,
    and v a strided view of the Dense's (BT, H, W, heads, 3, d) output."""
    rng = np.random.default_rng(seed)
    dense = torch.from_numpy(rng.standard_normal((bt, h, w, heads, 3, d)).astype(np.float32))
    dense = dense.to(device, torch.bfloat16)
    return dense[..., 0, :].contiguous(), dense[..., 1, :].contiguous(), dense[..., 2, :]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(SPLIT_KERNELS))
def test_k6_k7_read_a_strided_v_as_its_contiguous_copy_on_card(cuda_device, kernel):
    """The strided ``v`` view of a Dense output gives the same bits as its
    contiguous copy, forward and backward: the kernels read it in place."""
    fwd, bwd, _, _ = SPLIT_KERNELS[kernel]
    bt, h, w, heads, d = 40, 32, 32, 6, 64
    q, k, v = _layer_views(bt, h, w, heads, d, 87, cuda_device)
    assert not v.is_contiguous()
    tables = list(_split_args(1, h, w, heads, d, 88, device=cuda_device).values())[3:]
    do = torch.randn(bt, h, w, heads, d, generator=torch.Generator().manual_seed(89))
    do = do.to(cuda_device, torch.bfloat16)
    strided = (fwd(q, k, v, *tables), *bwd(do, q, k, v, *tables))
    copied = (fwd(q, k, v.contiguous(), *tables), *bwd(do, q, k, v.contiguous(), *tables))
    torch.cuda.synchronize()
    for a, b in zip(strided, copied):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fault", ["misaligned", "strided_last_dim"])
@pytest.mark.parametrize("name", ["q", "k", "v", "do"])
@pytest.mark.parametrize("kernel", list(SPLIT_PATHS))
def test_k6_k7_hopper_kernels_name_a_view_they_cannot_read(kernel, name, fault):
    """A bf16 q, k, v or do one element into its storage, or whose last dim
    is not contiguous, cannot be read by 16-byte loads: K6's and K7's Hopper
    kernels raise, naming it, before anything reaches the card (the check
    runs on the host, here on CPU tensors), and copy nothing."""
    hopper_fwd, hopper_bwd = SPLIT_PATHS[kernel][:2]
    shape = (2, 4, 8, 2, 16)
    args = _split_args(*shape[:3], 2, 16, 90, torch.bfloat16)
    tensors = dict(args, do=torch.zeros(shape, dtype=torch.bfloat16))
    if fault == "misaligned":
        tensors[name] = _misaligned(shape)
        message = f": {name} starts at .* not 16-byte aligned"
    else:
        tensors[name] = torch.zeros(*shape[:-1], 2 * shape[-1], dtype=torch.bfloat16)[..., ::2]
        message = f": {name} of shape .* is not contiguous in its last dim"
    qkv = [tensors[n] for n in "qkv"]
    tables = list(args.values())[3:]
    counts = _split_counts(kernel)
    with pytest.raises(ValueError, match=message):
        if name == "do":
            hopper_bwd(tensors["do"], *qkv, *tables)
        else:
            hopper_fwd(*qkv, *tables)
    assert _split_counts(kernel) == counts


@pytest.mark.parametrize("kernel", ["k6_fwd", "k6_bwd", "k7_fwd", "k7_bwd"])
def test_k6_k7_line_kernels_refuse_bfloat16(kernel):
    """K6's and K7's line-kernel paths are their float32 paths: a bfloat16
    call raises before it reaches a card, naming the Hopper kernels (K7's
    backward takes bfloat16 only on lines its Hopper backward does not
    stage)."""
    args = list(_split_args(1, 4, 8, 2, 16, 91, torch.bfloat16).values())
    _, _, line_fwd, line_bwd = SPLIT_PATHS[kernel[:2]]
    with pytest.raises(TypeError, match=kernel[:2].replace("k6", "fused_packed_hopper")
                       .replace("k7", "fused_hopper")):
        if kernel.endswith("fwd"):
            line_fwd(*args)
        else:
            line_bwd(torch.zeros(1, 4, 8, 2, 16, dtype=torch.bfloat16), *args)


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
            ((40, 32, 128, 384), 6), ((40, 64, 64, 96), 6), ((1, 16, 512, 384), 6),
            ((2, 8, 16, 64), 4)]
K9_IDS = ["slice", "training", "flow_b4", "flow_b8", "tiny_d16", "rows_512", "small"]
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
    paths = _k5_k9_counts()
    got = lane_px_attention(**args, heads=heads)
    grads = lane_px_attention_bwd(do, *args.values(), heads=heads)
    assert (lane_px_attention.launches, lane_px_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert _k5_k9_counts() == tuple(a + b for a, b in zip(paths, _path_step("k9", dtype)))
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


@pytest.mark.parametrize("chooser,hopper,line", [
    (mega_kernels, (mega_hopper_fwd, mega_hopper_bwd), (mega_line_fwd, mega_line_bwd)),
    (px_kernels, (px_hopper_fwd, px_hopper_bwd), (px_line_fwd, px_line_bwd)),
], ids=["k5", "k9"])
def test_k5_k9_kernels_are_chosen_by_dtype(chooser, hopper, line):
    """bfloat16 takes the Hopper chain, float32 the first chain; any other
    dtype has no kernel."""
    assert chooser(torch.bfloat16) == hopper
    assert chooser(torch.float32) == line
    with pytest.raises(TypeError, match="float16"):
        chooser(torch.float16)


def _misaligned(shape, dtype=torch.bfloat16):
    """A contiguous tensor of ``shape`` one element into its storage: no TMA
    source."""
    return torch.zeros(1 + int(np.prod(shape)), dtype=dtype)[1:].view(shape)


def _mega_residuals(bt, h, w, c):
    r = bt * h * w
    return (torch.zeros(2, bt, c), torch.zeros(r, 3 * c, dtype=torch.bfloat16),
            torch.zeros(r, c, dtype=torch.bfloat16))


@pytest.mark.parametrize("case,name", [("k5_fwd", "x"), ("k5_bwd", "do"), ("k9_fwd", "wqkv"),
                                       ("k9_bwd", "do")])
def test_k5_k9_hopper_chains_name_a_misaligned_view(case, name):
    """A bf16 operand one element into its storage cannot be a TMA source:
    K5's and K9's Hopper chains raise, naming it, before anything reaches the
    card (the check runs on the host, here on CPU tensors)."""
    shape, heads = (2, 8, 16, 64), 4
    if case.startswith("k5"):
        args = _k5_args(*shape[:3], 64, heads, 70, torch.bfloat16)
        params = list(args.values())[1:]
        if case == "k5_fwd":
            call = lambda: mega_hopper_fwd(_misaligned(shape), *params, heads=heads)  # noqa: E731
        else:
            call = lambda: mega_hopper_bwd(_misaligned(shape), args["x"], *params,  # noqa: E731
                                           heads=heads, residuals=_mega_residuals(2, 8, 16, 64))
    else:
        args = _px_args(shape, heads, 71, torch.bfloat16)
        params = list(args.values())[1:]
        if case == "k9_fwd":
            wqkv = _misaligned((3 * 64, 64))
            call = lambda: px_hopper_fwd(args["x"], wqkv, *params[1:], heads=heads)  # noqa: E731
        else:
            call = lambda: px_hopper_bwd(_misaligned(shape), args["x"], *params,  # noqa: E731
                                         heads=heads)
    counts = _k5_k9_counts()
    with pytest.raises(ValueError, match=f": {name} starts at .* not 16-byte aligned"):
        call()
    assert _k5_k9_counts() == counts


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype", [("k5", torch.float32), ("k9", torch.float32)],
                         ids=["k5_f32", "k9_f32"])
def test_k5_k9_float32_take_the_first_chains_on_card(cuda_device, kernel, dtype):
    """float32 stays on the first chains (block_gemm.cuh's tile and the line
    kernels): their counters move, the Hopper chains' do not."""
    shape, heads = (2, 8, 16, 64), 4
    before = _k5_k9_counts()
    if kernel == "k5":
        args = _k5_args(*shape[:3], 64, heads, 72, dtype, cuda_device)
        params = list(args.values())[1:]
        _, res = mega_axial_block_fwd(args["x"], *params, heads=heads)
        mega_axial_block_bwd(torch.ones_like(args["x"]), args["x"], *params, heads=heads,
                             residuals=res)
    else:
        args = _px_args(shape, heads, 73, dtype, cuda_device)
        lane_px_attention(**args, heads=heads)
        lane_px_attention_bwd(torch.ones_like(args["x"]), *args.values(), heads=heads)
    torch.cuda.synchronize()
    assert _k5_k9_counts() == tuple(a + b for a, b in zip(before, _path_step(kernel, dtype)))


def _repeat_case(kernel, device):
    """(backward call, argument names, the indices of its parameter
    gradients) of a kernel at its path's training shape."""
    dtype = torch.bfloat16 if kernel in ("k5", "k9") or kernel.endswith("_bf16") else torch.float32
    kernel = kernel.removesuffix("_bf16")
    if kernel == "k5":
        args = _k5_args(40, 32, 32, 384, 6, 74, dtype, device)
        params = list(args.values())[1:]
        _, res = mega_axial_block_fwd(args["x"], *params, heads=6)
        do = _bf16(args["x"].shape, 75, device)
        return (lambda: mega_axial_block_bwd(do, args["x"], *params, heads=6, residuals=res),
                list(args), range(1, len(args)))
    if kernel == "k9":
        args = _px_args((40, 32, 32, 384), 6, 76, dtype, device)
        do = _bf16(args["x"].shape, 77, device)
        return (lambda: lane_px_attention_bwd(do, *args.values(), heads=6), list(args),
                range(1, len(args)))
    if kernel in ("k2", "k4"):
        grid, c = ((20, 64, 256), 96) if kernel == "k2" else ((40, 32, 32), 384)
        args = _k2_args(*grid, c, 6, 78, dtype, device)
        do = torch.randn(*grid, c, generator=torch.Generator().manual_seed(79)).to(device)
        bwd = lane_axial_attention_bwd if kernel == "k2" else fused_block_attention_bwd
        return (lambda: bwd(do, *args.values(), heads=6), list(args), range(1, len(args)))
    if kernel in ("k6", "k7"):
        args = _split_args(40, 32, 32, 6, 64, 80, dtype, device)  # float32 and bfloat16
        do = torch.randn(40, 32, 32, 6, 64, generator=torch.Generator().manual_seed(81))
        do = do.to(device)
        bwd = fused_axial_attention_packed_bwd if kernel == "k6" else fused_axial_attention_bwd
        return lambda: bwd(do, *args.values()), list(args), range(3, len(args))
    shape = {"k8": (6, 1280, 32, 64), "k8_t": (6, 8192, 5, 64), "k8_d16": (6, 2560, 64, 16)}[kernel]
    args = _flash_args(shape, 82, dtype, device)
    do = torch.randn(shape, generator=torch.Generator().manual_seed(83)).to(device, dtype)
    return lambda: flash_packed_attention_bwd(do, *args.values()), list(args), range(3, len(args))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k5", "k9", "k2", "k4", "k6", "k7", "k8", "k4_bf16",
                                    "k8_bf16", "k8_t_bf16", "k8_d16_bf16", "k6_bf16", "k7_bf16"],
                         ids=["k5_bf16", "k9_bf16", "k2_f32_d16_flow", "k4_f32", "k6_f32",
                              "k7_f32", "k8_f32", "k4_bf16", "k8_bf16", "k8_temporal_bf16",
                              "k8_d16_bf16", "k6_bf16", "k7_bf16"])
def test_parameter_gradients_repeat_bit_for_bit_on_card(cuda_device, kernel):
    """K5's and K9's bf16 parameter gradients (split-K weight gradients,
    per-plane bias and InstanceNorm sums, per-block table, scale and LN
    partials, each added in a fixed order), the line kernels' float32
    table, scale and LN gradients (K2 at AViT-tiny's 512x2048 training grid,
    K4, K6, K7, K8: per-cluster partials) and K4's, K6's, K7's and K8's bf16
    ones (the Hopper kernels' per-block partials; K8 at its axial, temporal
    and head dim 16 lines) give the same bits over two calls."""
    call, names, which = _repeat_case(kernel, cuda_device)
    first = [None if g is None else g.clone() for g in call()]
    second = call()
    torch.cuda.synchronize()
    for i in which:
        if first[i] is not None:
            assert torch.equal(first[i], second[i]), names[i]


# ------------------------------------------------------ the probes (P1-P4)
# Each probe kernel against its plain version: on the CPU the wrapper is the
# plain version and counts nothing; on the card at the probe's default shape
# and at a small or ragged one.  Rolls, the 0/1 permutation product and
# every P4 copy are bit-exact; the float32 Gram and statistics within 1e-4
# (summation order), bfloat16 outputs within 2e-2 (TOL).


def _probe_small_inputs(seed):
    """Small inputs of every probe kernel (float32, CPU)."""
    rng = np.random.default_rng(seed)

    def n(*s, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32))

    heads, d, h, w, bt, ch = 2, 16, 8, 12, 3, 32
    c = heads * d
    lane = dict(q=n(bt, c, h * w), kv=n(bt, 2 * c, h * w), bx=n(w * heads, h * w, scale=0.1),
                by=n(h * heads, h * w, scale=0.1),
                sc=torch.from_numpy(rng.uniform(0.5, 1.5, (c, 2)).astype(np.float32)),
                heads=heads, h=h, w=w)
    args = SimpleNamespace(batch=1, tw=bt, grid=8, embed_dim=c, heads=heads, chunk=ch)
    chunk = {k: (v.float() if torch.is_tensor(v) else v)
             for k, v in chunk_axial.make_inputs(args).items()}
    stage = dict(y0=n(bt, 10, 14, 8), mean=n(bt, 8, scale=0.1),
                 inv=torch.from_numpy(rng.uniform(0.8, 1.2, (bt, 8)).astype(np.float32)),
                 k=n(2, 2, 8, 24, scale=0.05))
    perm = torch.from_numpy(np.eye(200, dtype=np.float32)[rng.permutation(200)])
    return lane, chunk, stage, (n(100, 200), perm)


def test_probe_wrappers_take_plain_versions_on_cpu():
    lane, chunk, stage, (x, p) = _probe_small_inputs(60)
    counters = (lane_axial.within_roll, lane_axial.lane_core, chunk_axial.dot_combos,
                chunk_axial.perm_product, chunk_axial.chunk_core, pyramid.stage, mosaic.gram,
                mosaic.view_copy, mosaic.chunk_gram_apply)
    before = [f.launches for f in counters]
    r = lane_axial.within_roll(lane["q"][0], 5, 12, 24, 96)
    assert torch.equal(r[1], lane_axial.within_roll_plain(lane["q"][0], 24, 96))
    torch.testing.assert_close(lane_axial.lane_core(**lane), lane_axial.lane_core_plain(**lane),
                               rtol=0, atol=0)
    xs = chunk_axial.dot_combos_input()
    for g, want in zip(chunk_axial.dot_combos(*xs), chunk_axial.dot_combos_plain(*xs)):
        assert torch.equal(g, want)
    assert torch.equal(chunk_axial.perm_product(x, p), chunk_axial.perm_product_plain(x, p))
    assert torch.equal(chunk_axial.chunk_core(**chunk), chunk_axial.chunk_core_plain(**chunk))
    for g, want in zip(pyramid.stage(**stage), pyramid.stage_plain(**stage)):
        assert torch.equal(g, want)
    for name in mosaic.BODIES:
        xb = mosaic.body_input(name)
        assert torch.equal(mosaic.run_body(name, xb), mosaic.run_body(name, xb, mosaic.PLAIN))
    assert [f.launches for f in counters] == before


def test_probe_wrappers_raise_on_other_devices():
    lane, chunk, stage, (x, p) = _probe_small_inputs(61)
    meta = {k: v.to("meta") if torch.is_tensor(v) else v for k, v in lane.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        lane_axial.lane_core(**meta)
    with pytest.raises(ValueError, match="unsupported device"):
        chunk_axial.perm_product(x.to("meta"), p.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        pyramid.stage(**{k: v.to("meta") for k, v in stage.items()})
    with pytest.raises(ValueError, match="unsupported device"):
        mosaic.gram(x.to("meta"))


def test_lane_core_operands_name_what_the_kernels_do_not_take():
    """lane_core's checks run before any launch: on meta tensors each names
    the tensor or the shape it refuses."""
    ok = {k: v.to("meta") if torch.is_tensor(v) else v
          for k, v in _lane_inputs(76, 2, 16, 8, 12, bt=1).items()}
    assert lane_axial.lane_core_operands(**ok).startswith("lane_core at q (1, 32, 96)")
    bad = [(dict(kv=ok["kv"][:, :40]), ValueError, "kv has shape"),
           (dict(bx=ok["bx"][:20]), ValueError, "bx has shape"),
           (dict(by=ok["by"][:, :50]), ValueError, "by has shape"),
           (dict(sc=ok["sc"][:, :1]), ValueError, "sc has shape"),
           (dict(kv=ok["kv"].float()), TypeError, "q and kv"),
           (dict(q=torch.zeros(1, 31, 96, device="meta", dtype=torch.bfloat16)), ValueError,
            "C a multiple"),
           (dict(h=6), ValueError, "N = h"),
           (dict(q=ok["q"].repeat(1, 2, 1), kv=ok["kv"].repeat(1, 2, 1),
                 sc=ok["sc"].repeat(2, 1)), ValueError, "head dims")]
    for change, error, match in bad:
        with pytest.raises(error, match=match):
            lane_axial.lane_core_operands(**dict(ok, **change))


def test_lane_core_kernels_by_dtype():
    assert lane_axial.lane_core_kernels(torch.bfloat16) is lane_axial.lane_core_hopper
    assert lane_axial.lane_core_kernels(torch.float32) is lane_axial.lane_core_line
    with pytest.raises(TypeError, match="float16"):
        lane_axial.lane_core_kernels(torch.float16)


@pytest.mark.parametrize("change,match", [
    (dict(axis=3), "chunks dividing"), (dict(chunk=5), "chunks dividing"),
    (dict(out=torch.empty(1, 32, 32, 6, 32, dtype=torch.bfloat16)), "out is"),
    (dict(out=torch.empty(1, 32, 32, 6, 64)), "out is"),
    (dict(x=torch.empty(1, 32, 32, 64, 6, dtype=torch.bfloat16).transpose(3, 4)),
     "x of strides"),
    (dict(x=torch.empty(1, 32, 32, 6, 32, dtype=torch.bfloat16),
          out=torch.empty(1, 32, 32, 6, 32, dtype=torch.bfloat16)), "head dims"),
    (dict(x=torch.empty(1, 64, 32, 1, 64, dtype=torch.bfloat16),
          out=torch.empty(1, 64, 32, 1, 64, dtype=torch.bfloat16), chunk=64), "does not fit"),
], ids=["axis", "chunk", "out_shape", "out_dtype", "strided_x", "d32", "too_long"])
def test_chunk_gram_operands_name_what_the_kernels_do_not_take(change, match):
    """chunk_gram_apply's checks run before any launch (CPU tensors)."""
    x = torch.empty(1, 32, 32, 6, 64, dtype=torch.bfloat16)
    args = dict(dict(x=x, out=torch.empty_like(x), axis=1, chunk=8), **change)
    assert mosaic.chunk_gram_operands(x, torch.empty_like(x), 1, 8).startswith(
        "chunk_gram_apply at (1, 32, 32, 6, 64)")
    with pytest.raises(ValueError, match=match):
        mosaic.chunk_gram_operands(**args)


def test_chunk_gram_kernels_by_dtype():
    assert mosaic.chunk_gram_kernels(torch.bfloat16) is mosaic.chunk_gram_hopper
    assert mosaic.chunk_gram_kernels(torch.float32) is mosaic.chunk_gram_line
    with pytest.raises(TypeError, match="float16"):
        mosaic.chunk_gram_kernels(torch.float16)


def _card(inputs, dev, dtype=None, slabs=()):
    return {k: (v.to(dev, dtype) if torch.is_tensor(v) and k in slabs else
                v.to(dev) if torch.is_tensor(v) else v) for k, v in inputs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_p1a_within_roll_is_exact_on_card(cuda_device, dtype):
    """The probe's slab and a ragged one (rows 7 of 3 x 40 lanes) on the
    staged 16-byte path; rows of 30 lanes (blocks of 10 and 15) and a
    misaligned slab on the element path: bit for bit, the two rolls the
    halves of one buffer, one launch a call."""
    s = lane_axial.ROLL_SHAPE
    g = torch.Generator().manual_seed(62)
    base = torch.randn(16 * 512 + 1, generator=g).to(dtype)
    cases = [(lane_axial.within_roll_input(dtype), (5, s.W, 3 * s.W, s.H * s.W), True),
             (torch.randn(7, 120, generator=g).to(dtype), (7, 40, 0, 120), True),
             (torch.randn(5, 30, generator=g).to(dtype), (4, 10, 14, 15), False)]
    for x, rolls, vec in cases:
        x = x.to(cuda_device)
        assert (lane_axial.within_roll_operands(x, *rolls) > 1) == vec
        cases_x = [x]
        if vec:  # the same slab one element into its storage
            off = base.to(cuda_device)[1:1 + x.numel()].view(x.shape).copy_(x)
            assert lane_axial.within_roll_operands(off, *rolls) == 1
            cases_x.append(off)
        for xx in cases_x:
            before = lane_axial.within_roll.launches
            got = lane_axial.within_roll(xx, *rolls)
            assert lane_axial.within_roll.launches == before + 1
            torch.cuda.synchronize()
            assert got[1].data_ptr() == got[0].data_ptr() + xx.numel() * xx.element_size()
            assert torch.equal(got[0], lane_axial.within_roll_plain(xx, *rolls[:2]))
            assert torch.equal(got[1], lane_axial.within_roll_plain(xx, *rolls[2:]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["default", "small_f32", "small_bf16"])
def test_p1b_lane_core_matches_plain_on_card(cuda_device, case):
    """The probe's default inputs (bf16, 20 frames of 32x32 tokens, C =
    384) and an 8x12 grid with 2 heads of 16 in both types."""
    if case == "default":
        inp = _card(lane_axial.make_inputs(lane_axial.parser().parse_args([])), cuda_device)
        dtype = torch.bfloat16
    else:
        dtype = torch.float32 if case == "small_f32" else torch.bfloat16
        inp = _card(_probe_small_inputs(63)[0], cuda_device, dtype, ("q", "kv"))
    before = lane_axial.lane_core.launches
    got = lane_axial.lane_core(**inp)
    assert lane_axial.lane_core.launches == before + 1 and got.dtype == dtype
    _close(got, lane_axial.lane_core_plain(**inp), dtype)


def _lane_inputs(seed, heads, d, h, w, bt=2, dtype=torch.bfloat16):
    """lane_core's inputs for ``heads`` heads of ``d`` on an h x w grid
    (q, kv in ``dtype``, the tables and scales float32), on the CPU."""
    rng = np.random.default_rng(seed)
    c, n = heads * d, h * w

    def r(*s, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32))

    return dict(q=r(bt, c, n).to(dtype), kv=r(bt, 2 * c, n).to(dtype),
                bx=r(w * heads, n, scale=0.1), by=r(h * heads, n, scale=0.1),
                sc=torch.from_numpy(rng.uniform(0.5, 1.5, (c, 2)).astype(np.float32)),
                heads=heads, h=h, w=w)


# (heads, d, h, w): P1b's bf16 kernel at head dims 16 and 64 on ragged lines
# (not a multiple of 16, W not a multiple of 8: one element a thread), on
# bands of 8 columns read by 16-byte loads (W a multiple of 8) with a short
# last row band, and on lines of MAX_LINE = 128 (two lines a block).
P1B_HOPPER_CASES = {"d16_ragged": (2, 16, 12, 20), "d64_ragged": (1, 64, 20, 12),
                    "d64_vector": (2, 64, 12, 24), "d16_rows128": (1, 16, 4, 128),
                    "d64_cols128": (1, 64, 128, 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(P1B_HOPPER_CASES))
def test_p1b_hopper_kernel_matches_plain_on_card(cuda_device, case):
    heads, d, h, w = P1B_HOPPER_CASES[case]
    inp = _card(_lane_inputs(70, heads, d, h, w), cuda_device)
    counts = [f.launches for f in (lane_axial.lane_core, lane_axial.lane_core_hopper,
                                   lane_axial.lane_core_line)]
    got = lane_axial.lane_core(**inp)
    assert [f.launches for f in (lane_axial.lane_core, lane_axial.lane_core_hopper,
                                 lane_axial.lane_core_line)] == [counts[0] + 1, counts[1] + 1,
                                                                 counts[2]]
    assert got.dtype == torch.bfloat16 and got.shape == inp["q"].shape
    _close(got, lane_axial.lane_core_plain(**inp), torch.bfloat16)
    assert torch.equal(got, lane_axial.lane_core(**inp))


@pytest.mark.cuda
def test_p1b_float32_stays_on_the_line_kernel_on_card(cuda_device):
    inp = _card(_lane_inputs(71, 2, 16, 8, 12, dtype=torch.float32), cuda_device)
    before = (lane_axial.lane_core_hopper.launches, lane_axial.lane_core_line.launches)
    _close(lane_axial.lane_core(**inp), lane_axial.lane_core_plain(**inp), torch.float32)
    assert (lane_axial.lane_core_hopper.launches,
            lane_axial.lane_core_line.launches) == (before[0], before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,d,h,w,match", [(1, 32, 8, 8, "head dims"),
                                               (2, 16, 4, 130, "lines of at most")],
                         ids=["d32", "line130"])
def test_p1b_hopper_kernel_raises_outside_its_shapes_on_card(cuda_device, heads, d, h, w,
                                                             match):
    inp = _card(_lane_inputs(72, heads, d, h, w, bt=1), cuda_device)
    before = lane_axial.lane_core_hopper.launches
    with pytest.raises(ValueError, match=match):
        lane_axial.lane_core(**inp)
    assert lane_axial.lane_core_hopper.launches == before


@pytest.mark.cuda
def test_p2a_dot_combos_matches_plain_on_card(cuda_device):
    """The probe's slabs, and slices of d = 16, 32 tokens of (40, 64) slabs."""
    g = torch.Generator().manual_seed(64)
    for (x, y), d, ch in ((chunk_axial.dot_combos_input(), 64, 128),
                          ((torch.randn(40, 64, generator=g).bfloat16(),
                            torch.randn(40, 64, generator=g).bfloat16()), 16, 32)):
        x, y = x.to(cuda_device), y.to(cuda_device)
        s, pv = chunk_axial.dot_combos(x, y, d, ch)
        s_ref, pv_ref = chunk_axial.dot_combos_plain(x, y, d, ch)
        _close(s, s_ref, torch.float32)
        _close(pv, pv_ref, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["probe", "small"])
def test_p2a_dot_combos_repeats_bit_for_bit_on_card(cuda_device, case):
    """P2a at both of its shapes (the probe's d = 64, chunk 128 slices and
    d = 16, chunk 32 of (40, 64) slabs): one launch a call, counted, and S
    and pv the same bits on a second call."""
    g = torch.Generator().manual_seed(74)
    if case == "probe":
        x, y = chunk_axial.dot_combos_input()
    else:
        x, y = (torch.randn(40, 64, generator=g).bfloat16() for _ in range(2))
    d, ch = (64, 128) if case == "probe" else (16, 32)
    x, y = x.to(cuda_device), y.to(cuda_device)
    before = chunk_axial.dot_combos.launches
    first = chunk_axial.dot_combos(x, y, d, ch)
    again = chunk_axial.dot_combos(x, y, d, ch)
    assert chunk_axial.dot_combos.launches == before + 2
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert first[0].shape == (ch, ch) and first[1].shape == (d, ch)


# The chunk attention kernel alone (both of P2c's passes): head dim 64 at
# every chunk the kernel takes, a head dim it pads (24 -> 32), the largest
# (128) and the small cards' d = 16.
CHUNK_CASES = [(64, 32), (64, 64), (64, 96), (64, 128), (24, 64), (128, 128), (16, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,ch", CHUNK_CASES, ids=[f"d{d}_ch{ch}" for d, ch in CHUNK_CASES])
def test_p2_chunk_attention_matches_plain_on_card(cuda_device, d, ch):
    """One pass of ``chunk_attention_kernel`` over 3 frames of 2 heads and
    3 chunks, held to ``_axis_pass_plain`` within the bf16 tolerance (pb is
    rounded to bf16, so a term that rounds the other way moves a float32 sum
    by a bf16 step of one term): float32 out as the row pass writes it,
    the same bits on a second call, and bf16 out as the column pass."""
    heads, bt, nch = 2, 3, 3
    c, n = heads * d, nch * ch
    g = torch.Generator().manual_seed(75)
    q = torch.randn(bt, c, n, generator=g).to(cuda_device, torch.bfloat16)
    kv = torch.randn(bt, 2 * c, n, generator=g).to(cuda_device, torch.bfloat16)
    bias = (0.1 * torch.randn(heads * ch, ch, generator=g)).to(cuda_device)
    mblk = torch.rand(ch, ch, generator=g).to(cuda_device)
    sc = (0.5 + torch.rand(heads, 2, generator=g)).to(cuda_device)
    common = dict(frames=bt, heads=heads, d=d, nchunks=nch, ch=ch, q_fs=c * n, kv_fs=2 * c * n,
                  ld=n, out_fs=c * n, out_ld=n, bias=bias, mblk=mblk, sc=sc, scaling=d**-0.5)
    want = chunk_axial._axis_pass_plain(q, kv[:, :c], kv[:, c:], bias, mblk, sc[:, 1], heads, ch)
    outs = []
    for dtype in (torch.float32, torch.float32, torch.bfloat16):
        out = torch.empty(bt, c, n, device=cuda_device, dtype=dtype)
        chunk_axial._chunk_attention(q, kv, kv[:, c:], out=out, sc_col=1, **common)
        outs.append(out)
    _close(outs[0], want, torch.bfloat16)
    assert torch.equal(outs[0], outs[1])
    _close(outs[2], want.to(torch.bfloat16), torch.bfloat16)


@pytest.mark.cuda
def test_p2b_perm_product_is_exact_on_card(cuda_device):
    """The probe's (384, 1024) slab and 32x32 grid permutation, and a random
    0/1 permutation of 200 lanes on 100 rows (ragged tiles)."""
    _, _, _, (x, p) = _probe_small_inputs(65)
    for x, p in (chunk_axial.perm_input(), (x.bfloat16(), p.bfloat16())):
        x, p = x.to(cuda_device), p.to(cuda_device)
        before = chunk_axial.perm_product.launches
        got = chunk_axial.perm_product(x, p)
        assert chunk_axial.perm_product.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, chunk_axial.perm_product_plain(x, p))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [7680, 15360], ids=["q", "kv"])
def test_p2b_perm_product_is_exact_at_p2c_relayout_shapes_on_card(cuda_device, rows):
    """bf16(x . P) at P2c's relayouts, q (20 frames x 384 channels) and kv
    (x 768) of 1024 tokens: the GEMM's 128-row tiles, bit for bit."""
    x = _bf16((rows, 1024), 70, cuda_device)
    p = chunk_axial.permutation(32, 32, torch.bfloat16).to(cuda_device)
    before = chunk_axial.perm_product.launches
    got = chunk_axial.perm_product(x, p)
    assert chunk_axial.perm_product.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, chunk_axial.perm_product_plain(x, p))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(7680, 1024), (384, 1024), (100, 200), (48, 64)],
                         ids=["p2c", "probe", "ragged", "p2c_small"])
def test_p2b_transposed_product_with_addend_is_exact_on_card(cuda_device, rows, n):
    """P2c's last product, bf16((addend + x . P^T) / 2) with a float32
    addend, bit for bit against its plain form (the GEMM's NT layout and its
    kHalfAdd epilogue)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(71)
    x = _bf16((rows, n), 72, cuda_device)
    p = torch.eye(n)[torch.randperm(n, generator=g)].to(cuda_device, torch.bfloat16)
    addend = torch.randn(rows, n, generator=g).to(cuda_device)
    out = torch.empty_like(x)
    chunk_axial._perm_product(x, p, out, addend=addend)
    want = (0.5 * (addend + x.float() @ p.float().t())).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_p2b_raises_where_tma_cannot_read_on_card(cuda_device):
    """n not a multiple of 8 (rows of 24 bytes) and an x one element into
    its storage raise before any launch, naming the tensor."""
    before = chunk_axial.perm_product.launches
    with pytest.raises(ValueError, match="x has rows of 24 bytes"):
        chunk_axial.perm_product(torch.zeros(4, 12, device=cuda_device, dtype=torch.bfloat16),
                                 torch.zeros(12, 12, device=cuda_device, dtype=torch.bfloat16))
    flat = torch.zeros(4 * 64 + 1, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="x starts at .* not 16-byte aligned"):
        chunk_axial.perm_product(flat[1:].view(4, 64),
                                 torch.zeros(64, 64, device=cuda_device, dtype=torch.bfloat16))
    assert chunk_axial.perm_product.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["default", "small"])
def test_p2c_chunk_core_matches_plain_on_card(cuda_device, case):
    """The probe's default inputs, and 2 heads of 16 on an 8x8 grid with
    chunks of 32 (bf16: the kernels take bf16 only)."""
    if case == "default":
        inp = _card(chunk_axial.make_inputs(chunk_axial.parser().parse_args([])), cuda_device)
    else:
        inp = _card(_probe_small_inputs(66)[1], cuda_device, torch.bfloat16, ("q", "kv", "perm"))
    before = chunk_axial.chunk_core.launches
    got = chunk_axial.chunk_core(**inp)
    assert chunk_axial.chunk_core.launches == before + 1
    _close(got, chunk_axial.chunk_core_plain(**inp), torch.bfloat16)



@pytest.mark.cuda
@pytest.mark.parametrize("name", ["br", "bc", "mrs", "mcs"])
def test_p2c_raises_for_a_misaligned_table_on_card(cuda_device, name):
    """A contiguous bias or Mblk table one float off a 16-byte boundary (the
    kernel reads the tables 16 bytes at a time) raises before any launch,
    naming the table, where the kernel would fault."""
    inp = _card(_probe_small_inputs(66)[1], cuda_device, torch.bfloat16, ("q", "kv", "perm"))
    t = inp[name].float()
    flat = torch.zeros(t.numel() + 4, device=cuda_device)
    inp[name] = flat[1:1 + t.numel()].view(t.shape).copy_(t)
    before = chunk_axial.chunk_core.launches
    with pytest.raises(ValueError, match=f"{name} starts at .* not 16-byte aligned"):
        chunk_axial.chunk_core(**inp)
    assert chunk_axial.chunk_core.launches == before

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["default", "ragged", "rows", "wide"])
def test_p3_stage_matches_plain_on_card(cuda_device, case):
    """The probe's (20, 256, 256, 96) stage, 3 images of 10x14 pixels, 8
    channels in and 24 out (a ragged tile of 5 rows of 7), (2, 64, 64, 96)
    -> 96 (rows of 32 pixels, four a tile), and (2, 14, 40, 36) -> 192 (2C
    = 72 over two 64-column stages, two output-channel tiles, the second of
    64 columns; tiles of 6 rows of 20 pixels, the second ragged)."""
    if case == "default":
        inp = _card(pyramid.make_inputs(pyramid.parser().parse_args([])), cuda_device)
    elif case == "ragged":
        inp = _card(_probe_small_inputs(67)[2], cuda_device, torch.bfloat16, ("y0", "k"))
    else:
        bt, hw, c, f = (2, (64, 64), 96, 96) if case == "rows" else (2, (14, 40), 36, 192)
        args = SimpleNamespace(bt=bt, size=hw[0], cin=c, cout=f)
        inp = pyramid.make_inputs(args)
        if case == "wide":
            g = torch.Generator().manual_seed(76)
            inp["y0"] = torch.randn(bt, *hw, c, generator=g).bfloat16()
        inp = _card(inp, cuda_device)
    before = pyramid.stage.launches
    got = pyramid.stage(**inp)
    assert pyramid.stage.launches == before + 1
    want = pyramid.stage_plain(**inp)
    _close(got[0], want[0], torch.bfloat16)
    _close(got[1], want[1], torch.float32)
    _close(got[2], want[2], torch.float32)
    again = pyramid.stage(**inp)
    assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])  # fixed order


@pytest.mark.cuda
def test_p3_stage_raises_where_tma_cannot_read_on_card(cuda_device):
    """C = 6 (a pixel pair's 12 channels are 24 bytes) and F = 12 (rows of
    k of 24 bytes) raise before any launch, naming the tensor."""
    y0 = torch.zeros(1, 4, 4, 6, device=cuda_device, dtype=torch.bfloat16)
    stats = torch.zeros(1, 6, device=cuda_device)
    before = pyramid.stage.launches
    with pytest.raises(ValueError, match="y0 has rows of 24 bytes"):
        pyramid.stage(y0, stats, stats, torch.zeros(2, 2, 6, 8, device=cuda_device,
                                                     dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="k has rows of 24 bytes"):
        pyramid.stage(torch.zeros(1, 4, 4, 8, device=cuda_device, dtype=torch.bfloat16),
                      torch.zeros(1, 8, device=cuda_device), torch.zeros(1, 8, device=cuda_device),
                      torch.zeros(2, 2, 8, 12, device=cuda_device, dtype=torch.bfloat16))
    assert pyramid.stage.launches == before



@pytest.mark.cuda
@pytest.mark.parametrize("past", [0, 4], ids=["most", "past"])
def test_p3_stage_channel_limit_on_card(cuda_device, past):
    """The most input channels the kernel's shared memory stages statistics
    for (``bf_probe_stage_max_channels``, from the kernel's own sizes): at
    that C a 4 x 4 image matches the plain version; 4 channels more raise
    before any launch, naming y0."""
    from bubbleformer_tpu_torch import _build

    c = _build.library().bf_probe_stage_max_channels() + past
    inp = _card(pyramid.make_inputs(SimpleNamespace(bt=1, size=4, cin=c, cout=8)), cuda_device)
    before = pyramid.stage.launches
    if past:
        with pytest.raises(ValueError, match=f"y0 has {c} channels"):
            pyramid.stage(**inp)
        assert pyramid.stage.launches == before
        return
    got = pyramid.stage(**inp)
    assert pyramid.stage.launches == before + 1
    want = pyramid.stage_plain(**inp)
    for g, w, dtype in zip(got, want, (torch.bfloat16, torch.float32, torch.float32)):
        _close(g, w, dtype)

@pytest.mark.cuda
@pytest.mark.parametrize("name", list(mosaic.BODIES))
def test_p4_bodies_match_plain_on_card(cuda_device, name):
    x = mosaic.body_input(name).to(cuda_device)
    got = mosaic.run_body(name, x)
    want = mosaic.run_body(name, x, mosaic.PLAIN)
    torch.cuda.synchronize()
    kernel = mosaic.BODY_KERNEL[name]
    if kernel == "view_copy":
        assert torch.equal(got, want)
    else:
        _close(got, want, torch.float32 if kernel == "gram" else x.dtype)
    assert getattr(mosaic, f"probe_{name}")(cuda_device)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_p4_kernels_take_strided_ragged_views_on_card(cuda_device, dtype):
    """A Gram of a (70, 40) column slice of a transposed tensor, an
    accumulating copy between two strided views, and the per-chunk products
    over (2, 8, 12, 3, 16) by rows and by columns."""
    g = torch.Generator().manual_seed(68)
    big = torch.randn(50, 90, generator=g).to(cuda_device, dtype)
    a = big.t()[:70, 5:45]
    assert not a.is_contiguous()
    _close(mosaic.gram(a), mosaic.gram_plain(a), torch.float32)
    src = torch.randn(6, 7, 5, generator=g).to(cuda_device, dtype).permute(2, 0, 1)
    dst = torch.randn(5, 12, 7, generator=g).to(cuda_device, dtype)[:, ::2]
    want = mosaic.view_copy_plain(src, dst.clone(), 1.5, accumulate=True)
    assert torch.equal(mosaic.view_copy(src, dst, 1.5, accumulate=True), want)
    x = torch.randn(2, 8, 12, 3, 16, generator=g).to(cuda_device, dtype)
    for axis, chunk in ((1, 4), (2, 6)):
        got = mosaic.chunk_gram_apply(x, torch.ones_like(x), axis, chunk, accumulate=True)
        want = mosaic.chunk_gram_apply_plain(x, torch.ones_like(x), axis, chunk, accumulate=True)
        _close(got, want, dtype)


def _gram_views(dev):
    """Each Gram body's view (16-byte path), the ragged transposed slice
    (element path, 2-D), rows that fold to no one stride (element path over
    the view) and a bf16 view of 3 column chunks and ragged rows."""
    views = {}
    for name in mosaic.BODIES:
        if mosaic.BODY_KERNEL[name] == "gram":
            x = mosaic.body_input(name).to(dev)
            ops = SimpleNamespace(gram=lambda a, name=name: views.setdefault(name, a))
            mosaic.run_body(name, x, ops)
    g = torch.Generator().manual_seed(77)
    views["ragged_t"] = torch.randn(50, 90, generator=g).to(dev).t()[:70, 5:45]
    views["unfolded"] = torch.randn(8, 12, 40, generator=g).to(dev)[:, :10]
    views["wide_bf16"] = torch.randn(70, 136, generator=g).to(dev, torch.bfloat16)
    return views


@pytest.mark.cuda
def test_p4_gram_is_exactly_symmetric_and_repeats_on_card(cuda_device):
    """Every Gram view within TOL (1e-4 of the largest magnitude) of
    gram_plain, its planned path as named, out equal to out^T bit for bit
    (one triangle of tiles, each written to both places) and two calls
    equal bit for bit (fixed-order sums), one launch a call."""
    paths = {"ragged_t": False, "unfolded": None, "wide_bf16": True}
    for name, a in _gram_views(cuda_device).items():
        rows, cols, row_stride, _, vec = mosaic.gram_operands(a)
        assert (None if row_stride is None else vec) == paths.get(name, True), name
        before = mosaic.gram.launches
        runs = [mosaic.gram(a) for _ in range(2)]
        assert mosaic.gram.launches == before + 2
        _close(runs[0], mosaic.gram_plain(a), torch.float32)
        assert runs[0].shape == (rows, rows)
        assert torch.equal(runs[0], runs[0].t()), name
        assert torch.equal(runs[0], runs[1]), name


@pytest.mark.cuda
@pytest.mark.parametrize("accumulate", [False, True], ids=["write", "add"])
@pytest.mark.parametrize("axis", [1, 2], ids=["rows", "cols"])
@pytest.mark.parametrize("shape,chunk", [((1, 32, 32, 6, 64), 8), ((2, 8, 12, 3, 16), 4)],
                         ids=["probe", "d16"])
def test_p4_chunk_gram_hopper_repeats_bit_for_bit_on_card(cuda_device, shape, chunk, axis,
                                                         accumulate):
    """The bf16 chunk kernel over row and column chunks, writing and adding:
    within 2e-2 of the plain version, the same bits in two runs, one launch
    of the Hopper kernel a call."""
    g = torch.Generator().manual_seed(74)
    x = torch.randn(*shape, generator=g).to(cuda_device, torch.bfloat16)
    base = torch.randn(*shape, generator=g).to(cuda_device, torch.bfloat16)
    counts = (mosaic.chunk_gram_apply.launches, mosaic.chunk_gram_hopper.launches,
              mosaic.chunk_gram_line.launches)
    runs = [mosaic.chunk_gram_apply(x, base.clone(), axis, chunk, accumulate) for _ in range(2)]
    assert (mosaic.chunk_gram_apply.launches, mosaic.chunk_gram_hopper.launches,
            mosaic.chunk_gram_line.launches) == (counts[0] + 2, counts[1] + 2, counts[2])
    want = mosaic.chunk_gram_apply_plain(x, base.clone(), axis, chunk, accumulate)
    _close(runs[0], want, torch.bfloat16)
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_p4_chunk_gram_float32_stays_on_the_line_kernel_on_card(cuda_device):
    g = torch.Generator().manual_seed(75)
    x = torch.randn(2, 8, 12, 3, 16, generator=g).to(cuda_device)
    before = (mosaic.chunk_gram_hopper.launches, mosaic.chunk_gram_line.launches)
    got = mosaic.chunk_gram_apply(x, torch.empty_like(x), 2, 6)
    _close(got, mosaic.chunk_gram_apply_plain(x, torch.empty_like(x), 2, 6), torch.float32)
    assert (mosaic.chunk_gram_hopper.launches,
            mosaic.chunk_gram_line.launches) == (before[0], before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("src_dtype,dst_dtype", [(torch.float32, torch.float32),
                                                 (torch.bfloat16, torch.bfloat16),
                                                 (torch.float32, torch.bfloat16)],
                         ids=["f32", "bf16", "f32_to_bf16"])
def test_p4_view_copy_is_exact_on_vector_and_unaligned_views_on_card(cuda_device, src_dtype,
                                                                    dst_dtype):
    """An accumulating copy from rows of 64 values whose run starts one
    element into its storage (no 16-byte vectors: one element a thread) and
    from the same rows aligned (16 bytes a thread), each bit for bit; the
    wrapper counts both launches."""
    g = torch.Generator().manual_seed(73)
    base = torch.randn(32 * 64 + 8, generator=g).to(cuda_device, src_dtype)
    dst = torch.randn(32, 64, generator=g).to(cuda_device, dst_dtype)
    before = mosaic.view_copy.launches
    for src, vec in ((base[1:1 + 32 * 64].view(32, 64), 1),
                     (base[8:].view(32, 64), 16 // base.element_size())):
        shape, fs, fd = mosaic.fold_views(src.shape, src.stride(), dst.stride())
        assert mosaic.copy_vector(shape, fs, fd, src.element_size(), dst.element_size(),
                                  src.data_ptr() % 16, dst.data_ptr() % 16) == vec
        want = mosaic.view_copy_plain(src, dst.clone(), 1.5, accumulate=True)
        got = mosaic.view_copy(src, dst.clone(), 1.5, accumulate=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert mosaic.view_copy.launches == before + 2


@pytest.mark.cuda
def test_probe_kernels_raise_outside_their_envelope_on_card(cuda_device):
    lane, chunk, stage, _ = _probe_small_inputs(69)
    long = dict(_card(lane, cuda_device), q=torch.zeros(1, 32, 130 * 2, device=cuda_device),
                kv=torch.zeros(1, 64, 260, device=cuda_device),
                bx=torch.zeros(260, 260, device=cuda_device),
                by=torch.zeros(4, 260, device=cuda_device), h=2, w=130)
    with pytest.raises(ValueError, match="lines of at most"):
        lane_axial.lane_core(**long)
    with pytest.raises(TypeError, match="bfloat16"):
        chunk_axial.chunk_core(**_card(chunk, cuda_device))  # float32
    with pytest.raises(ValueError, match="output channels"):
        pyramid.stage(**dict(_card(stage, cuda_device, torch.bfloat16, ("y0", "k")),
                             k=torch.zeros(2, 2, 8, 200, device=cuda_device,
                                           dtype=torch.bfloat16)))


# ---------------------------------------------------------------------------
# The Hopper GEMM of K1's products (csrc/hopper_gemm.cuh, ops/hopper_gemm.py)
# and K1's bf16 launch chains on it.

# Split-K weight gradients of K1: dW_qkv and dW_out at FiLMAViT-small's
# training and rollout token counts, AViT-tiny's (head dim 16) at 512x512,
# and ragged token counts (not a multiple of the 64-token stage).
SPLIT_CASES = [(40960, 1152, 384), (40960, 384, 384), (5120, 1152, 384), (163840, 288, 96),
               (163840, 96, 96), (777, 136, 200), (65, 8, 8), (1, 1152, 384),
               (40960, 2304, 768), (163840, 1152, 384), (327680, 288, 96)]
SPLIT_IDS = ["training_qkv", "training_out", "rollout_qkv", "d16_qkv", "d16_out", "ragged",
             "ragged_small", "one_token", "k3_avit_big_qkv", "k3_flow_b8_qkv",
             "k3_flow_d16_qkv"]


@pytest.mark.parametrize("tokens,m,n", SPLIT_CASES, ids=SPLIT_IDS)
def test_split_k_plan_covers_every_token_once(tokens, m, n):
    """The token ranges the wrapper hands the split-K GEMM: from 0 to the
    last token, none empty, every inner bound on a 64-token stage, at most
    the kernel's 64 ranges; together they cover each token exactly once."""
    bounds = hopper_gemm.split_k_plan(tokens, m, n)
    assert bounds[0] == 0 and bounds[-1] == tokens
    assert 1 <= len(bounds) - 1 <= hopper_gemm.MAX_SPLITS
    assert all(a < b for a, b in zip(bounds, bounds[1:]))
    assert all(b % hopper_gemm.BLOCK_K == 0 for b in bounds[1:-1])
    covered = np.concatenate([np.arange(a, b) for a, b in zip(bounds, bounds[1:])])
    np.testing.assert_array_equal(covered, np.arange(tokens))


def test_split_k_plan_fills_the_card_at_the_training_shape():
    """dW_qkv at the training shape: 27 output tiles of 128 x 128, so about
    ten token ranges bring the blocks near two a streaming multiprocessor."""
    bounds = hopper_gemm.split_k_plan(40960, 1152, 384)
    assert len(bounds) - 1 == 10
    assert abs(27 * (len(bounds) - 1) - hopper_gemm.TARGET_BLOCKS) < 27


def test_split_k_plan_fills_the_card_at_avit_big_shape():
    """K3's dW_qkv at AViT-big's training shape: 18 x 6 = 108 output tiles,
    so two token ranges bring the blocks nearest two a streaming
    multiprocessor, and each partial is 3C x C float32 (14 MB for both)."""
    bounds = hopper_gemm.split_k_plan(40960, 2304, 768)
    assert bounds == [0, 20480, 40960]
    assert abs(108 * (len(bounds) - 1) - hopper_gemm.TARGET_BLOCKS) < 108


def test_hopper_gemm_nt_rounds_without_a_bias_on_cpu():
    """The no-bias rounding form (K3's dx): ``bf16(a @ b^T)`` from the
    plain version, no launch; float32 with a bias is no form of the GEMM."""
    g = torch.Generator().manual_seed(51)
    a = torch.randn(7, 24, generator=g).to(torch.bfloat16)
    b = torch.randn(16, 24, generator=g).to(torch.bfloat16)
    before = hopper_gemm.gemm_nt.launches
    got = hopper_gemm.gemm_nt(a, b, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and hopper_gemm.gemm_nt.launches == before
    torch.testing.assert_close(got, (a.float() @ b.float().t()).to(torch.bfloat16), rtol=0,
                               atol=0)
    torch.testing.assert_close(got, hopper_gemm.gemm_nt_plain(a, b, out_dtype=torch.bfloat16),
                               rtol=0, atol=0)


def test_k3_wrappers_raise_on_launch_ms_in_float32_and_off_the_card():
    """Per-launch times are the bf16 chains' on the card: both K3 wrappers
    raise for ``launch_ms`` with a float32 ``xn``, and for one on the CPU;
    without it the forward still raises on a CPU or meta tensor, and the
    backward takes its plain version on the CPU and raises on meta."""
    args = _k3_args((1, 3, 4, 8, 16), 2, 52)
    params, dao = list(args.values())[1:], torch.randn(1, 3, 4, 8, 16)
    for xn in (args["xn"], args["xn"].to(torch.bfloat16)):
        why = "bf16 chain's" if xn.dtype == torch.float32 else "the card's"
        with pytest.raises(ValueError, match=why):
            temporal_block_mega.core_temporal_attention_fwd(xn, *params, heads=2, launch_ms={})
        with pytest.raises(ValueError, match=why):
            core_temporal_attention_bwd(dao, xn, *params, heads=2, launch_ms={})
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        temporal_block_mega.core_temporal_attention_fwd(args["xn"], *params, heads=2)
    got = core_temporal_attention_bwd(dao, args["xn"], *params, heads=2)
    want = core_temporal_bwd_plain(dao, **args, heads=2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    meta = [a.to("meta") for a in args.values()]
    with pytest.raises(ValueError, match="CUDA tensor, not meta"):
        temporal_block_mega.core_temporal_attention_fwd(*meta, heads=2)
    with pytest.raises(ValueError, match="unsupported device meta"):
        core_temporal_attention_bwd(dao.to("meta"), *meta, heads=2)


def test_hopper_gemm_wrappers_take_plain_versions_on_cpu():
    g = torch.Generator().manual_seed(40)
    a, b = torch.randn(7, 24, generator=g), torch.randn(16, 24, generator=g)
    bias = torch.randn(16, generator=g)
    before = (hopper_gemm.gemm_nt.launches, hopper_gemm.gemm_tn.launches)
    torch.testing.assert_close(hopper_gemm.gemm_nt(a, b), a @ b.t(), rtol=0, atol=0)
    torch.testing.assert_close(hopper_gemm.gemm_nt(a, b, bias, torch.bfloat16),
                               (a @ b.t() + bias).to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(hopper_gemm.gemm_tn(a, a[:, :8]), a.t() @ a[:, :8], rtol=0, atol=0)
    assert (hopper_gemm.gemm_nt.launches, hopper_gemm.gemm_tn.launches) == before


def test_hopper_gemm_nn_takes_its_plain_version_on_cpu():
    g = torch.Generator().manual_seed(76)
    a, b = torch.randn(7, 24, generator=g), torch.randn(24, 16, generator=g)
    before = hopper_gemm.gemm_nn.launches
    torch.testing.assert_close(hopper_gemm.gemm_nn(a, b), (a @ b).to(torch.bfloat16), rtol=0,
                               atol=0)
    assert hopper_gemm.gemm_nn.launches == before


def test_check_tma_names_what_the_kernels_do_not_take():
    """The TMA loads need 16-byte aligned bases and rows: a view one element
    in, a row of 6 bf16 values and a transposed view each raise, naming the
    tensor."""
    flat = torch.zeros(8 + 4 * 64, dtype=torch.bfloat16)
    _build.check_tma("k", ok=flat[8:].view(4, 64))
    with pytest.raises(ValueError, match="k: do starts at .* not 16-byte aligned"):
        _build.check_tma("k", do=flat[1:257].view(4, 64))
    with pytest.raises(ValueError, match="k: w has rows of 12 bytes"):
        _build.check_tma("k", w=torch.zeros(4, 6, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="k: x of shape \\(64, 4\\) is not contiguous"):
        _build.check_tma("k", x=flat[8:].view(4, 64).t())


def _bf16(shape, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device, torch.bfloat16)


# NT: (M, N, K) at K1's QKV product (training shape), its output product at
# the rollout, and ragged ones (M not a multiple of 128, N and K not of 64).
NT_CASES = [(40960, 1152, 384), (5120, 384, 384), (300, 96, 96), (1000, 136, 1160), (130, 8, 72)]
NT_IDS = ["qkv_training", "out_rollout", "ragged_d16", "ragged_wide", "ragged_thin"]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", NT_CASES, ids=NT_IDS)
def test_hopper_gemm_nt_matches_matmul_on_card(cuda_device, m, n, k):
    """``a @ b^T`` of bf16 values against ``torch.matmul`` in float32 (no
    TF32): float32 out within 1e-5 of its largest value (summation order),
    and bf16(sum + bias) within one bf16 rounding of each value (2^-8 of
    it) plus that summation-order bound."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = _bf16((m, k), 41, cuda_device), _bf16((n, k), 42, cuda_device)
    bias = torch.randn(n, generator=torch.Generator().manual_seed(43)).to(cuda_device)
    want = torch.matmul(a.float(), b.float().t())
    before = hopper_gemm.gemm_nt.launches
    got = hopper_gemm.gemm_nt(a, b)
    got_b = hopper_gemm.gemm_nt(a, b, bias, torch.bfloat16)
    assert hopper_gemm.gemm_nt.launches == before + 2
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    ref_b = want + bias
    bound = 2.0**-8 * ref_b.abs() + 1e-5 * ref_b.abs().max()
    assert ((got_b.float() - ref_b).abs() <= bound).all()


# bf16(a @ b^T) without a bias, K3's dx: at AViT-big's (dqkv (R, 3C) times
# W_qkv^T), AViT-tiny's on the flow-boiling grid (K of 288, N of 96), and
# ragged ones.
ROUND_CASES = [(40960, 768, 2304), (163840, 384, 1152), (20480, 96, 288), (300, 96, 288),
               (130, 8, 72)]
ROUND_IDS = ["k3_avit_big_dx", "k3_flow_b8_dx", "k3_d16_dx", "ragged_d16", "ragged_thin"]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", ROUND_CASES, ids=ROUND_IDS)
def test_hopper_gemm_nt_rounds_without_a_bias_on_card(cuda_device, m, n, k):
    """``bf16(a @ b^T)`` against ``torch.matmul`` in float32 (no TF32),
    within one bf16 rounding of each value plus 1e-5 of the largest
    (summation order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = _bf16((m, k), 53, cuda_device), _bf16((n, k), 54, cuda_device)
    want = torch.matmul(a.float(), b.float().t())
    before = hopper_gemm.gemm_nt.launches
    got = hopper_gemm.gemm_nt(a, b, out_dtype=torch.bfloat16)
    assert hopper_gemm.gemm_nt.launches == before + 1 and got.dtype == torch.bfloat16
    torch.cuda.synchronize()
    bound = 2.0**-8 * want.abs() + 1e-5 * want.abs().max()
    assert ((got.float() - want).abs() <= bound).all()


# TN: (R tokens, M, N, bounds or None for the wrapper's plan): K1's dW_qkv
# and dW_out at the training shape, AViT-tiny's dW_qkv, and ragged ones (R
# not a multiple of the ranges, M and N not of 128).
TN_CASES = [(40960, 1152, 384, None), (40960, 384, 384, None), (163840, 288, 96, None),
            (5000, 136, 200, None), (777, 136, 200, [0, 128, 512, 777]), (100, 8, 16, [0, 100])]
TN_IDS = ["qkv_training", "out_training", "d16", "ragged", "ragged_bounds", "one_range"]


@pytest.mark.cuda
@pytest.mark.parametrize("r,m,n,bounds", TN_CASES, ids=TN_IDS)
def test_hopper_gemm_tn_matches_matmul_on_card(cuda_device, r, m, n, bounds):
    """``d^T @ s`` over R tokens, split-K, against ``torch.matmul`` in
    float32 (no TF32), within 1e-5 of its largest value; a second call
    gives the same bits (the partials are added in a fixed order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    d, s = _bf16((r, m), 44, cuda_device), _bf16((r, n), 45, cuda_device)
    want = torch.matmul(d.float().t(), s.float())
    before = hopper_gemm.gemm_tn.launches
    got = hopper_gemm.gemm_tn(d, s, bounds)
    again = hopper_gemm.gemm_tn(d, s, bounds)
    assert hopper_gemm.gemm_tn.launches == before + 2
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert torch.equal(got, again)


# NN: (M, N, K) at the P2 probe's permutation product, P2c's q relayout and
# ragged ones (M not a multiple of 64, N and K not of 128).  On a card of
# 132 SMs the probe's and the two thin ones run on 64-row tiles (fewer
# 128-row blocks than SMs), P2c's and ragged_wide on 128-row tiles.
NN_CASES = [(384, 1024, 1024), (7680, 1024, 1024), (100, 200, 200), (65, 136, 72),
            (2000, 1096, 72)]
NN_IDS = ["probe", "p2c_q", "ragged", "ragged_thin", "ragged_wide"]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", NN_CASES, ids=NN_IDS)
def test_hopper_gemm_nn_matches_matmul_on_card(cuda_device, m, n, k):
    """``bf16(a @ b)``, b read MN-major, on the tile height its shape gets,
    against ``torch.matmul`` in float32 (no TF32), within one bf16 rounding
    of each value plus 1e-5 of the largest (summation order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = _bf16((m, k), 74, cuda_device), _bf16((k, n), 75, cuda_device)
    want = torch.matmul(a.float(), b.float())
    before = hopper_gemm.gemm_nn.launches
    got = hopper_gemm.gemm_nn(a, b)
    assert hopper_gemm.gemm_nn.launches == before + 1 and got.dtype == torch.bfloat16
    torch.cuda.synchronize()
    bound = 2.0**-8 * want.abs() + 1e-5 * want.abs().max()
    assert ((got.float() - want).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 5, 32, 32, 384), (2, 5, 64, 64, 96)],
                         ids=["training", "d16"])
def test_k1_weight_gradients_repeat_bit_for_bit_on_card(cuda_device, shape):
    """In bf16 K1's weight gradients are split-K sums added in a fixed
    order: two backward calls on the same inputs give the same bits."""
    heads = 6
    args = _k1_args(shape, heads, 46, torch.bfloat16, cuda_device)
    do = _bf16(shape, 47, cuda_device)
    params = list(args.values())[1:]
    _, res = mega_temporal_block_fwd(args["x"], *params, heads=heads)
    first = mega_temporal_block_bwd(do, args["x"], *params, heads=heads, residuals=res)
    second = mega_temporal_block_bwd(do, args["x"], *params, heads=heads, residuals=res)
    torch.cuda.synchronize()
    names = ("x",) + temporal_block_mega.PARAM_NAMES
    for name in ("wqkv", "wout"):
        i = names.index(name)
        assert torch.equal(first[i], second[i]), name


@pytest.mark.cuda
def test_k1_wrappers_raise_on_a_misaligned_view_on_card(cuda_device):
    """A bf16 output gradient one element into its storage cannot be a TMA
    source: the backward raises, naming it, before any launch; so does the
    forward for a misaligned weight."""
    shape, heads = (1, 3, 8, 16, 128), 2
    args = _k1_args(shape, heads, 48, torch.bfloat16, cuda_device)
    params = list(args.values())[1:]
    _, res = mega_temporal_block_fwd(args["x"], *params, heads=heads)
    flat = torch.zeros(1 + int(np.prod(shape)), device=cuda_device, dtype=torch.bfloat16)
    do = flat[1:].view(shape)
    before = mega_temporal_block_bwd.launches
    with pytest.raises(ValueError, match="do starts at .* not 16-byte aligned"):
        mega_temporal_block_bwd(do, args["x"], *params, heads=heads, residuals=res)
    assert mega_temporal_block_bwd.launches == before
    wflat = torch.zeros(1 + 3 * 128 * 128, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wqkv starts at"):
        mega_temporal_block(**dict(args, wqkv=wflat[1:].view(3 * 128, 128)), heads=heads)


@pytest.mark.cuda
def test_k1_per_launch_times_on_card(cuda_device):
    """In bf16 the wrappers report each launch's device time by CUDA events,
    in chain order; float32 has no chain to time and raises."""
    shape, heads = (2, 5, 32, 32, 384), 6
    args = _k1_args(shape, heads, 49, torch.bfloat16, cuda_device)
    params = list(args.values())[1:]
    fwd, bwd = {}, {}
    _, res = mega_temporal_block_fwd(args["x"], *params, heads=heads, launch_ms=fwd)
    mega_temporal_block_bwd(_bf16(shape, 50, cuda_device), args["x"], *params, heads=heads,
                            residuals=res, launch_ms=bwd)
    assert tuple(fwd) == temporal_block_mega.FWD_LAUNCHES
    assert tuple(bwd) == temporal_block_mega.BWD_LAUNCHES
    assert all(0 < v < 1e3 for v in (*fwd.values(), *bwd.values()))
    with pytest.raises(ValueError, match="bf16 chain"):
        mega_temporal_block_fwd(args["x"].float(), *params, heads=heads, launch_ms={})


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads", [((8, 5, 32, 32, 768), 12), ((1, 5, 64, 256, 96), 6)],
                         ids=["d64", "d16"])
def test_k3_weight_gradients_repeat_bit_for_bit_on_card(cuda_device, shape, heads):
    """In bf16 K3's dW_qkv is a split-K sum added in a fixed order: two
    backward calls on the same inputs give the same bits, at AViT-big's
    training shape and at AViT-tiny's on the flow-boiling grid."""
    args = _k3_args(shape, heads, 55, torch.bfloat16, cuda_device)
    dao = _bf16(shape, 56, cuda_device)
    params = list(args.values())[1:]
    first = core_temporal_attention_bwd(dao, args["xn"], *params, heads=heads)
    second = core_temporal_attention_bwd(dao, args["xn"], *params, heads=heads)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[0], second[0])  # dx: the same dqkv through the same GEMM


@pytest.mark.cuda
def test_k3_wrappers_raise_on_a_misaligned_view_on_card(cuda_device):
    """A bf16 output gradient one element into its storage cannot be a TMA
    source: K3's backward raises, naming it, before any launch; so does the
    forward for a misaligned weight and for a misaligned xn."""
    shape, heads = (1, 3, 8, 16, 128), 2
    args = _k3_args(shape, heads, 57, torch.bfloat16, cuda_device)
    params = list(args.values())[1:]
    flat = torch.zeros(1 + int(np.prod(shape)), device=cuda_device, dtype=torch.bfloat16)
    before = (core_temporal_attention.launches, core_temporal_attention_bwd.launches)
    with pytest.raises(ValueError, match="dao starts at .* not 16-byte aligned"):
        core_temporal_attention_bwd(flat[1:].view(shape), args["xn"], *params, heads=heads)
    with pytest.raises(ValueError, match="xn starts at .* not 16-byte aligned"):
        core_temporal_attention(**dict(args, xn=flat[1:].view(shape)), heads=heads)
    wflat = torch.zeros(1 + 3 * 128 * 128, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wqkv starts at"):
        core_temporal_attention(**dict(args, wqkv=wflat[1:].view(3 * 128, 128)), heads=heads)
    assert (core_temporal_attention.launches, core_temporal_attention_bwd.launches) == before


@pytest.mark.cuda
def test_k3_per_launch_times_on_card(cuda_device):
    """In bf16 K3's wrappers report each launch's device time by CUDA
    events, in chain order; float32 keeps the first version's launches and
    raises."""
    shape, heads = (2, 5, 32, 32, 768), 12
    args = _k3_args(shape, heads, 58, torch.bfloat16, cuda_device)
    params = list(args.values())[1:]
    fwd, bwd = {}, {}
    temporal_block_mega.core_temporal_attention_fwd(args["xn"], *params, heads=heads,
                                                    launch_ms=fwd)
    core_temporal_attention_bwd(_bf16(shape, 59, cuda_device), args["xn"], *params, heads=heads,
                                launch_ms=bwd)
    assert tuple(fwd) == temporal_block_mega.CORE_FWD_LAUNCHES
    assert tuple(bwd) == temporal_block_mega.CORE_BWD_LAUNCHES
    assert all(0 < v < 1e3 for v in (*fwd.values(), *bwd.values()))
    with pytest.raises(ValueError, match="bf16 chain"):
        temporal_block_mega.core_temporal_attention_fwd(args["xn"].float(), *params, heads=heads,
                                                        launch_ms={})
