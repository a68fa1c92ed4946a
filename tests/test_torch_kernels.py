"""The port's kernel wrappers: on CPU tensors they take the plain version and
count no launch; on a CUDA card (tests marked ``cuda``, skipped without one)
each kernel is held against its plain version at the shapes of the
rollout (batch 1) and of the training step (batch 8), and at smaller ones:
K1 and K2 at FiLMAViT-small's width (C=384), K3 and K2 at AViT-big's
(C=768), K3 also at FiLMAViT-small's 1024x1024 token grid.

This file imports no JAX, so the ``cuda`` tests also run where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Card tolerances, as in ``chip_smoke.py``: 1e-4 (float32, summation order
only) and 2e-2 (bfloat16, single-ulp rounding flips and what they propagate
into) of the reference's largest magnitude.  The backward kernels are held
to the same, gradient by gradient (``tests/_torch_grads.py``): their float32
sums are also reordered by atomics from run to run.
"""
import numpy as np
import pytest
import torch

from bubbleformer_tpu_torch import _build
from bubbleformer_tpu_torch.ops.axial_lane import (
    axial_attention_bwd_plain,
    axial_attention_plain,
    lane_axial_attention,
    lane_axial_attention_bwd,
)
from bubbleformer_tpu_torch.ops.temporal_block_mega import (
    core_temporal_attention,
    core_temporal_attention_bwd,
    core_temporal_attention_fwd,
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
    _, qkv = core_temporal_attention_fwd(args["xn"], *params, heads=heads)
    before = core_temporal_attention_bwd.launches
    got = core_temporal_attention_bwd(dao, args["xn"], *params, heads=heads, qkv=qkv)
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
    kernel each; under no_grad the forward writes no qkv residual."""
    args = {k: v.requires_grad_() for k, v in _k3_args((1, 3, 8, 16, 128), 2, 17,
                                                        device=cuda_device).items()}
    counts = (core_temporal_attention.launches, core_temporal_attention_bwd.launches)
    core_temporal_attention(**args, heads=2).square().sum().backward()
    torch.cuda.synchronize()
    assert (core_temporal_attention.launches,
            core_temporal_attention_bwd.launches) == (counts[0] + 1, counts[1] + 1)
    assert all(torch.isfinite(v.grad).all() for v in args.values())
    with torch.no_grad():
        core_temporal_attention(**args, heads=2)
    _, qkv = core_temporal_attention_fwd(*(v.detach() for v in args.values()), heads=2,
                                         keep_qkv=False)
    assert qkv is None
