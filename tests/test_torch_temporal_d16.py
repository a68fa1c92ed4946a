"""K1 and K3 at head dim 16 (AViT-tiny's and FiLMAViT-tiny's 6 heads of 16).

The port's plain versions against the JAX package's ``mega_temporal_block``
and ``core_temporal_attention`` run in interpret mode, forward and every
gradient, at C = 96 and 6 heads (the heads come in the card kernels' groups
of three at this head dim), T = 3 on an 8x16 token grid.  The kernels
themselves are held to these plain versions on the card by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.

Tolerances, relative to each output's or gradient's largest magnitude (the
k-LayerNorm bias's gradient, zero up to rounding, against a hundredth of the
largest of the call), as in ``tests/test_torch_temporal_grad.py`` and
``tests/test_torch_core.py``: 2e-5 in float32 (one function, summed in other
orders), 2e-2 in bfloat16 (the same rounding points, single-ulp flips and
what they propagate into; K1's port also recomputes IN2 from its float32
``ao`` where the TPU kernel reads a bfloat16 copy).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.ops import temporal_block_mega as jax_ops
from bubbleformer_tpu_torch.ops.temporal_block_mega import (
    CORE_PARAM_NAMES,
    PARAM_NAMES,
    core_temporal_bwd_plain,
    core_temporal_plain,
    temporal_branch_bwd_plain,
    temporal_branch_plain,
)
from tests._torch_grads import check_grads

SHAPE = (1, 3, 8, 16, 96)  # (B, T, H, W, C): 6 heads of 16
HEADS = 6
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DENSE = ("wqkv", "wout")  # torch (out, in) in the port, (in, out) in JAX
# kernel -> (argument names, JAX entry, plain forward, plain backward)
KERNELS = {
    "K1": (("x",) + PARAM_NAMES, jax_ops.mega_temporal_block, temporal_branch_plain,
           temporal_branch_bwd_plain),
    "K3": (("xn",) + CORE_PARAM_NAMES, jax_ops.core_temporal_attention, core_temporal_plain,
           core_temporal_bwd_plain),
}


def _args(names, seed):
    """Numpy inputs of ``names`` in the port's layout and an output gradient."""
    rng = np.random.default_rng(seed)
    b, t, h, w, c = SHAPE
    d = c // HEADS

    def n(*s, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(s)).astype(np.float32)

    every = dict(
        x=n(*SHAPE), in1_scale=n(c, scale=0.2, offset=1.0), in1_bias=n(c, scale=0.2),
        wqkv=n(3 * c, c, scale=c**-0.5), bqkv=n(3 * c, scale=0.2),
        qn_scale=n(d, scale=0.2, offset=1.0), qn_bias=n(d, scale=0.2),
        kn_scale=n(d, scale=0.2, offset=1.0), kn_bias=n(d, scale=0.2),
        in2_scale=n(c, scale=0.2, offset=1.0), in2_bias=n(c, scale=0.2),
        wout=n(c, c, scale=c**-0.5), bout=n(c, scale=0.2), bias=n(HEADS, t, t),
        scale_factor=rng.uniform(0.5, 1.5, HEADS).astype(np.float32),
    )
    every["xn"] = every["x"]
    return {k: every[k] for k in names}, n(*SHAPE)


def _torch(a, dtype):
    out = {k: torch.from_numpy(v) for k, v in a.items()}
    first = next(iter(out))
    out[first] = out[first].to(dtype)
    return out


def _jax(a, dtype):
    ja = {k: jnp.asarray(v).T if k in DENSE else jnp.asarray(v) for k, v in a.items()}
    first = next(iter(ja))
    ja[first] = ja[first].astype(dtype)
    return ja


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_plain_matches_jax_at_head_dim_16(kernel, dtype):
    names, jax_fn, plain, _ = KERNELS[kernel]
    a, _ = _args(names, 0)
    want = jax_fn(**_jax(a, dtype), heads=HEADS, interpret=True)
    assert want.dtype == jnp.dtype(dtype)
    want = np.asarray(want.astype(jnp.float32))
    got = plain(**_torch(a, getattr(torch, dtype)), heads=HEADS)
    assert got.dtype == getattr(torch, dtype) and got.shape == SHAPE
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL[dtype] * np.abs(want).max(), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_plain_backward_matches_jax_grad_at_head_dim_16(kernel, dtype):
    """Gradients of sum(out * do) through the JAX kernel in interpret mode,
    its hand-written backward included."""
    names, jax_fn, _, bwd_plain = KERNELS[kernel]
    a, do = _args(names, 1)
    ja = _jax(a, dtype)

    def loss(*vals):
        out = jax_fn(**dict(zip(names, vals)), heads=HEADS, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do))

    grads = jax.grad(loss, argnums=tuple(range(len(names))))(*(ja[k] for k in names))
    want = {k: np.asarray(g.astype(jnp.float32)) for k, g in zip(names, grads)}
    for k in DENSE:
        if k in want:
            want[k] = want[k].T
    tdt = getattr(torch, dtype)
    got = bwd_plain(torch.from_numpy(do).to(tdt), **_torch(a, tdt), heads=HEADS)
    assert got[0].dtype == tdt
    check_grads(names, got, [want[k] for k in names], TOL[dtype])
