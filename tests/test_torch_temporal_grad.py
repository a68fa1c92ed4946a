"""K1's backward: the port's plain backward (the formulas its CUDA kernel
computes) against float64 autograd of the plain forward, and against
``jax.grad`` through the JAX megakernel run in interpret mode, as the JAX
package's own tests run it on the CPU.  Every parameter and ``x``.

Tolerances, relative to each gradient's largest magnitude, or to a
hundredth of the largest magnitude of all gradients where that is larger
(the gradient of the k-LayerNorm bias is zero up to rounding: a shift of
every key leaves the softmax unchanged, so both sides return rounding
noise):

* float64 plain backward vs float64 autograd: 1e-9 — the same function,
  differentiated by hand and by the tape (measured 1e-15);
* float32 vs JAX: 2e-5 — the same formulas in float32, summed in other
  orders (measured 9e-7);
* bfloat16 vs JAX: 1e-2 — both round xn, qkv, q/k, y2, dao, s*dao and dqkv
  to bfloat16 (2^-8 relative) and both recompute InstanceNorm2 from the
  bfloat16 copy of ``ao``, but sum in other orders, so single-ulp flips at
  different points propagate through two InstanceNorm backwards (measured
  3.2e-3, on dx; 6.5e-3 when the port kept the float32 ``ao``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.ops.temporal_block_mega import mega_temporal_block as jax_mega
from bubbleformer_tpu_torch.ops.temporal_block_mega import (
    PARAM_NAMES,
    mega_temporal_block,
    mega_temporal_block_bwd,
    temporal_branch_bwd_plain,
    temporal_branch_plain,
)
from tests._torch_grads import check_grads, single_thread

SHAPE = (2, 3, 8, 16, 32)
HEADS = 4
NAMES = ("x",) + PARAM_NAMES


def _branch_args(seed):
    """Numpy inputs in the port's layout (torch (out, in) weights) and an
    output gradient."""
    rng = np.random.default_rng(seed)
    b, t, h, w, c = SHAPE
    d = c // HEADS

    def n(*s, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(s)).astype(np.float32)

    args = dict(
        x=n(*SHAPE), in1_scale=n(c, scale=0.2, offset=1.0), in1_bias=n(c, scale=0.2),
        wqkv=n(3 * c, c, scale=c**-0.5), bqkv=n(3 * c, scale=0.2),
        qn_scale=n(d, scale=0.2, offset=1.0), qn_bias=n(d, scale=0.2),
        kn_scale=n(d, scale=0.2, offset=1.0), kn_bias=n(d, scale=0.2),
        in2_scale=n(c, scale=0.2, offset=1.0), in2_bias=n(c, scale=0.2),
        wout=n(c, c, scale=c**-0.5), bout=n(c, scale=0.2),
        bias=n(HEADS, t, t), scale_factor=rng.uniform(0.5, 1.5, HEADS).astype(np.float32),
    )
    return args, n(*SHAPE)


def _torch(args, dtype):
    out = {k: torch.from_numpy(v).to(torch.float64 if dtype == torch.float64 else torch.float32)
           for k, v in args.items()}
    out["x"] = out["x"].to(dtype)
    return out


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_plain_backward_matches_float64_autograd():
    args, do = _branch_args(0)
    ta = {k: v.requires_grad_() for k, v in _torch(args, torch.float64).items()}
    out = temporal_branch_plain(**ta, heads=HEADS)
    dout = torch.from_numpy(do).double()
    want = torch.autograd.grad(out, list(ta.values()), dout)
    got = temporal_branch_bwd_plain(dout, **{k: v.detach() for k, v in ta.items()},
                                    heads=HEADS)
    check_grads(NAMES, got, [w.numpy() for w in want], 1e-9)


def _jax_grads(args, do, dtype):
    """Gradients of sum(out * do) through the JAX megakernel in interpret mode,
    mapped to the port's layouts ((in, out) Dense kernels transposed)."""
    ja = {k: jnp.asarray(v) for k, v in args.items()}
    ja["wqkv"], ja["wout"] = ja["wqkv"].T, ja["wout"].T
    ja["x"] = ja["x"].astype(dtype)

    def loss(*vals):
        out = jax_mega(**dict(zip(NAMES, vals)), heads=HEADS, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do))

    grads = jax.grad(loss, argnums=tuple(range(len(NAMES))))(*(ja[k] for k in NAMES))
    grads = dict(zip(NAMES, (np.asarray(g.astype(jnp.float32)) for g in grads)))
    grads["wqkv"], grads["wout"] = grads["wqkv"].T, grads["wout"].T
    return grads


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 1e-2)])
def test_plain_backward_matches_jax_megakernel(dtype, tol):
    args, do = _branch_args(1)
    want = _jax_grads(args, do, dtype)
    tdt = getattr(torch, dtype)
    got = temporal_branch_bwd_plain(torch.from_numpy(do).to(tdt), **_torch(args, tdt),
                                    heads=HEADS)
    assert got[0].dtype == tdt
    check_grads(NAMES, got, [want[k] for k in NAMES], tol)


def test_autograd_function_takes_the_plain_backward_on_cpu():
    """``mega_temporal_block`` differentiates through the plain backward on
    CPU tensors and counts no kernel launch."""
    with single_thread():
        args, do = _branch_args(2)
        ta = {k: v.requires_grad_() for k, v in _torch(args, torch.float32).items()}
        before = (mega_temporal_block.launches, mega_temporal_block_bwd.launches)
        out = mega_temporal_block(**ta, heads=HEADS)
        got = torch.autograd.grad(out, list(ta.values()), torch.from_numpy(do))
        assert (mega_temporal_block.launches, mega_temporal_block_bwd.launches) == before
        want = temporal_branch_bwd_plain(torch.from_numpy(do),
                                         **{k: v.detach() for k, v in ta.items()}, heads=HEADS)
        for name, g, w in zip(NAMES, got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


def test_absent_bias_and_scale_have_no_gradient():
    args, do = _branch_args(3)
    ta = _torch(args, torch.float32)
    ta["bias"] = ta["scale_factor"] = None
    got = temporal_branch_bwd_plain(torch.from_numpy(do), **ta, heads=HEADS)
    assert got[-2] is None and got[-1] is None
    ta64 = {k: None if v is None else v.double().requires_grad_() for k, v in ta.items()}
    out = temporal_branch_plain(**ta64, heads=HEADS)
    want = torch.autograd.grad(out, [ta64["x"], ta64["wqkv"]], torch.from_numpy(do).double())
    assert _rel_err(got[0], want[0]) <= 1e-4 and _rel_err(got[3], want[1]) <= 1e-4
