"""K2's backward: the port's plain backward (the formulas its CUDA kernel
computes) against float64 autograd of the plain forward, and the port's
``lane_axial_attention_from_x`` differentiated end to end (the QKV ``addmm``
by autograd, the attention core by the plain backward) against ``jax.grad``
through the JAX lane kernel run in interpret mode, on a square and an 8x16
token grid (4 heads of 8) and on rows of 128 tokens (a 4x128 grid, 2 heads
of 16).  Every parameter and ``x``.

Tolerances, relative to each gradient's largest magnitude as
``tests/_torch_grads.py`` says:

* float64 plain backward vs float64 autograd: 1e-9;
* float32 vs JAX: 2e-5, summation order only;
* bfloat16 vs JAX: 2e-2.  Both round q/k, ``dS``, the blended
  probabilities and each direction's ``dqkv`` to bfloat16, but the JAX
  package projects QKV once per direction and sums the two projections'
  gradients in float32, where the port sums the two bfloat16 ``dqkv`` into
  its one QKV tensor and rounds once more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.ops.axial_lane import lane_axial_attention_from_x as jax_lane
from bubbleformer_tpu_torch.ops.axial_lane import (
    axial_attention_bwd_plain,
    axial_attention_plain,
    lane_axial_attention,
    lane_axial_attention_bwd,
    lane_axial_attention_from_x,
)
from tests._torch_grads import check_grads, single_thread

C, HEADS = 32, 4
CORE = ("qkv", "qn_scale", "qn_bias", "kn_scale", "kn_bias", "bias_x", "bias_y", "scale_x",
        "scale_y")
FROM_X = ("x", "wqkv", "bqkv") + CORE[1:]


def _args(bt, h, w, seed, heads=HEADS):
    """Numpy inputs of the lane entry (torch (out, in) ``wqkv``), the raw QKV
    of the core, and an output gradient."""
    rng = np.random.default_rng(seed)
    d = C // heads

    def n(*s, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(s)).astype(np.float32)

    a = dict(
        x=n(bt, h, w, C), wqkv=n(3 * C, C, scale=C**-0.5), bqkv=n(3 * C, scale=0.2),
        qkv=n(bt, h, w, 3 * C), qn_scale=n(d, scale=0.2, offset=1.0), qn_bias=n(d, scale=0.2),
        kn_scale=n(d, scale=0.2, offset=1.0), kn_bias=n(d, scale=0.2),
        bias_x=n(heads, w, w), bias_y=n(heads, h, h),
        scale_x=rng.uniform(0.5, 1.5, heads).astype(np.float32),
        scale_y=rng.uniform(0.5, 1.5, heads).astype(np.float32),
    )
    return a, n(bt, h, w, C)


@pytest.mark.parametrize("grid", [(8, 8), (8, 16)], ids=["square", "nonsquare"])
def test_plain_backward_matches_float64_autograd(grid):
    a, do = _args(2, *grid, seed=grid[1])
    ta = {k: torch.from_numpy(a[k]).double().requires_grad_() for k in CORE}
    out = axial_attention_plain(**ta, heads=HEADS)
    dout = torch.from_numpy(do).double()
    want = torch.autograd.grad(out, list(ta.values()), dout)
    got = axial_attention_bwd_plain(dout, **{k: v.detach() for k, v in ta.items()}, heads=HEADS)
    check_grads(CORE, got, [w.numpy() for w in want], 1e-9)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("grid,bt,heads", [((8, 8), 3, HEADS), ((8, 16), 3, HEADS),
                                           ((4, 128), 2, 2)],
                         ids=["square", "nonsquare", "long_lines"])
def test_from_x_gradients_match_jax_lane_kernel(grid, bt, heads, dtype, tol):
    a, do = _args(bt, *grid, seed=grid[1] + 1, heads=heads)
    ja = {k: jnp.asarray(a[k]) for k in FROM_X}
    ja["wqkv"] = ja["wqkv"].T  # flax (in, out)
    ja["x"] = ja["x"].astype(dtype)

    def loss(*vals):
        out = jax_lane(**dict(zip(FROM_X, vals)), heads=heads, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do))

    jg = jax.grad(loss, argnums=tuple(range(len(FROM_X))))(*(ja[k] for k in FROM_X))
    want = [np.asarray(g.astype(jnp.float32)) for g in jg]
    want[1] = want[1].T

    ta = {k: torch.from_numpy(a[k]).requires_grad_() for k in FROM_X}
    xin = ta["x"].to(getattr(torch, dtype))
    out = lane_axial_attention_from_x(xin, *(ta[k] for k in FROM_X[1:]), heads=heads)
    assert out.dtype == getattr(torch, dtype)
    got = torch.autograd.grad(out.float(), list(ta.values()), torch.from_numpy(do))
    check_grads(FROM_X, got, want, tol)


def test_autograd_function_takes_the_plain_backward_on_cpu():
    with single_thread():
        a, do = _args(2, 4, 8, seed=5)
        ta = {k: torch.from_numpy(a[k]).requires_grad_() for k in CORE}
        before = (lane_axial_attention.launches, lane_axial_attention_bwd.launches)
        out = lane_axial_attention(**ta, heads=HEADS)
        got = torch.autograd.grad(out, list(ta.values()), torch.from_numpy(do))
        assert (lane_axial_attention.launches, lane_axial_attention_bwd.launches) == before
        want = axial_attention_bwd_plain(torch.from_numpy(do),
                                         **{k: v.detach() for k, v in ta.items()}, heads=HEADS)
        for name, g, w in zip(CORE, got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


def test_bwd_wrapper_raises_on_other_devices():
    a, do = _args(1, 4, 4, seed=6)
    ta = {k: torch.from_numpy(a[k]).to("meta") for k in CORE}
    with pytest.raises(ValueError, match="unsupported device"):
        lane_axial_attention_bwd(torch.from_numpy(do).to("meta"), *ta.values(), heads=HEADS)
