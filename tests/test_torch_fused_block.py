"""K4, the axial attention of the ``fused_block`` route, and K2 on a line of
128 tokens.

The port's plain versions against the JAX package's ``fused_block_attention``
and ``lane_axial_attention_from_x`` run in interpret mode (as the JAX
package's own tests run its Pallas kernels on the CPU), and the port's plain
K4 backward against float64 autograd of its plain forward.  Small widths:
2 heads of 16 or 64, token grids with h != w.

Tolerances, relative to each output's or gradient's largest magnitude (a
gradient zero up to rounding, the k-LayerNorm bias's, against a hundredth of
the largest of the call; ``tests/_torch_grads.py``):

* float32 vs JAX: 2e-5 — the same formulas in float32, summed in other
  orders (measured ~5e-7);
* bfloat16 vs JAX: 2e-2 — both round q/k, the probabilities, ``dao``,
  ``s * dao``, ``dS`` and ``dqkv`` to bfloat16 (2^-8 relative) at the same
  points: single-ulp flips where reassociated float32 sums straddle a
  rounding edge, and what they propagate into;
* float64 plain backward vs float64 autograd: 1e-9 — one function,
  differentiated by hand and by the tape.

The kernels themselves are held to these plain versions on the card by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.ops.axial_fused_block import fused_block_attention as jax_fused_block
from bubbleformer_tpu.ops.axial_lane import lane_axial_attention_from_x as jax_lane
from bubbleformer_tpu_torch.ops.axial_fused_block import (
    fused_block_attention,
    fused_block_attention_bwd,
    fused_block_bwd_plain,
    fused_block_plain,
)
from bubbleformer_tpu_torch.ops.axial_lane import lane_axial_attention_from_x
from tests._torch_grads import check_grads, single_thread

NAMES = ("qkv", "qn_scale", "qn_bias", "kn_scale", "kn_bias", "bias_x", "bias_y", "scale_x",
         "scale_y")
# (BT, H, W, heads, d): head dim 16 (AViT-tiny's) and 64 (every other
# config's), both with h != w.
CASES = [(2, 4, 6, 2, 16), (1, 8, 4, 2, 64)]
CASE_IDS = ["d16", "d64"]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _args(case, seed):
    """Numpy inputs of the fused_block entry and an output gradient."""
    bt, h, w, heads, d = case
    c = heads * d
    rng = np.random.default_rng(seed)

    def n(*s, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(s)).astype(np.float32)

    a = dict(
        qkv=n(bt, h, w, 3 * c), qn_scale=n(d, scale=0.2, offset=1.0), qn_bias=n(d, scale=0.2),
        kn_scale=n(d, scale=0.2, offset=1.0), kn_bias=n(d, scale=0.2),
        bias_x=n(heads, w, w), bias_y=n(heads, h, h),
        scale_x=rng.uniform(0.5, 1.5, heads).astype(np.float32),
        scale_y=rng.uniform(0.5, 1.5, heads).astype(np.float32),
    )
    return a, n(bt, h, w, c)


def _torch(a, dtype):
    out = {k: torch.from_numpy(v) for k, v in a.items()}
    out["qkv"] = out["qkv"].to(dtype)
    return out


def _jax(a, dtype):
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    ja["qkv"] = ja["qkv"].astype(dtype)
    return ja


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_fused_block_plain_matches_jax_interpret(case, dtype):
    a, _ = _args(case, 0)
    heads = case[3]
    want = jax_fused_block(**_jax(a, dtype), heads=heads, interpret=True)
    assert want.dtype == jnp.dtype(dtype)
    want = np.asarray(want.astype(jnp.float32)).reshape(*case[:3], -1)
    got = fused_block_plain(**_torch(a, getattr(torch, dtype)), heads=heads)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL[dtype] * np.abs(want).max(), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_fused_block_plain_backward_matches_jax_grad(case, dtype):
    """Gradients of sum(out * do) through the JAX kernel in interpret mode,
    its hand-written backward (``_bwd_kernel``) included."""
    a, do = _args(case, 1)
    heads = case[3]
    ja = _jax(a, dtype)

    def loss(*vals):
        out = jax_fused_block(**dict(zip(NAMES, vals)), heads=heads, interpret=True)
        return jnp.sum(out.astype(jnp.float32).reshape(do.shape) * jnp.asarray(do))

    grads = jax.grad(loss, argnums=tuple(range(len(NAMES))))(*(ja[k] for k in NAMES))
    tdt = getattr(torch, dtype)
    got = fused_block_bwd_plain(torch.from_numpy(do).to(tdt), **_torch(a, tdt), heads=heads)
    assert got[0].dtype == tdt
    check_grads(NAMES, got, [np.asarray(g.astype(jnp.float32)) for g in grads], TOL[dtype])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_fused_block_plain_backward_matches_float64_autograd(case):
    a, do = _args(case, 2)
    ta = {k: torch.from_numpy(v).double().requires_grad_() for k, v in a.items()}
    out = fused_block_plain(**ta, heads=case[3])
    dout = torch.from_numpy(do).double()
    want = torch.autograd.grad(out, list(ta.values()), dout)
    got = fused_block_bwd_plain(dout, **{k: v.detach() for k, v in ta.items()}, heads=case[3])
    check_grads(NAMES, got, [w.numpy() for w in want], 1e-9)


def test_fused_block_function_takes_the_plain_versions_on_cpu():
    """``fused_block_attention`` runs the plain forward and differentiates
    through the plain backward on CPU tensors, counting no kernel launch;
    absent tables and scales get no gradient."""
    with single_thread():
        a, do = _args(CASES[0], 3)
        ta = {k: v.requires_grad_() for k, v in _torch(a, torch.float32).items()}
        before = (fused_block_attention.launches, fused_block_attention_bwd.launches)
        out = fused_block_attention(**ta, heads=2)
        torch.testing.assert_close(out, fused_block_plain(**ta, heads=2), rtol=0, atol=0)
        got = torch.autograd.grad(out, list(ta.values()), torch.from_numpy(do))
        assert (fused_block_attention.launches, fused_block_attention_bwd.launches) == before
        want = fused_block_bwd_plain(torch.from_numpy(do),
                                     **{k: v.detach() for k, v in ta.items()}, heads=2)
        for name, g, w in zip(NAMES, got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
        bare = {k: v.detach() for k, v in ta.items() if k not in NAMES[5:]}
        grads = fused_block_attention_bwd(torch.from_numpy(do), *bare.values(), heads=2)
        assert grads[5:] == (None,) * 4


def _lane_args(bt, h, w, c, heads, seed):
    rng = np.random.default_rng(seed)
    d = c // heads

    def n(*s, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(s)).astype(np.float32)

    return dict(
        x=n(bt, h, w, c), wqkv=n(c, 3 * c, scale=c**-0.5), bqkv=n(3 * c, scale=0.2),
        qn_scale=n(d, scale=0.2, offset=1.0), qn_bias=n(d, scale=0.2),
        kn_scale=n(d, scale=0.2, offset=1.0), kn_bias=n(d, scale=0.2),
        bias_x=n(heads, w, w), bias_y=n(heads, h, h),
        scale_x=rng.uniform(0.5, 1.5, heads).astype(np.float32),
        scale_y=rng.uniform(0.5, 1.5, heads).astype(np.float32),
    ), n(bt, h, w, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lane_plain_matches_jax_on_a_line_of_128_tokens(dtype):
    """K2 on rows of 128 tokens (a 2x128 token grid, C=32, 4 heads), the
    shape class of the 32x128 flow-boiling grid: the port's plain version
    of ``lane_axial_attention_from_x`` against the JAX lane kernel in
    interpret mode, forward and, in float32, every gradient."""
    a, do = _lane_args(2, 2, 128, 32, 4, 4)
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    ja["x"] = ja["x"].astype(dtype)
    names = list(a)

    def loss(*vals):
        out = jax_lane(**dict(zip(names, vals)), heads=4, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do)), out

    (_, want), grads = jax.value_and_grad(loss, argnums=tuple(range(len(names))),
                                          has_aux=True)(*(ja[k] for k in names))
    want = np.asarray(want.astype(jnp.float32))
    ta = {k: torch.from_numpy(v).requires_grad_() for k, v in a.items()}
    ta["wqkv"] = ta["wqkv"].detach().t().contiguous().requires_grad_()  # torch (out, in)
    xin = ta["x"].to(getattr(torch, dtype))
    got = lane_axial_attention_from_x(xin, *list(ta.values())[1:], heads=4)
    assert got.dtype == getattr(torch, dtype)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= TOL[dtype] * np.abs(want).max(), err
    if dtype == "float32":
        got_g = torch.autograd.grad(got, list(ta.values()), torch.from_numpy(do))
        want_g = [np.asarray(g) for g in grads]
        want_g[1] = want_g[1].T
        check_grads(["x", "wqkv", "bqkv", "qn_scale", "qn_bias", "kn_scale", "kn_bias",
                     "bias_x", "bias_y", "scale_x", "scale_y"], got_g, want_g, TOL[dtype])
