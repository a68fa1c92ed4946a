"""InstanceNorm's hand-written gradient (``layers/norm.py``'s autograd
Function, the port of ``bubbleformer_tpu/layers/norm.py:32-71``) held two
ways, so that a mismatch can be traced to one side: against
``torch.autograd`` of the plain expression in float64, and against
``jax.grad`` through the JAX package's ``_instance_norm`` custom VJP.

Tolerances, relative to each gradient's largest magnitude: 1e-10 in float64
(the same function, differentiated by hand and by the tape); 2e-5 in
float32 against JAX (summation order over 256 elements per statistic);
bfloat16 against JAX 1e-2 for ``dx`` (rounded once to bfloat16 on both
sides, 2^-8 relative) and 2e-5 for the float32 affine gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.layers.norm import _instance_norm as jax_instance_norm
from bubbleformer_tpu_torch.layers.norm import InstanceNorm, instance_norm
from tests._torch_grads import check_grads

SHAPE = (3, 2, 16, 16, 8)  # (..., H, W, C) channels-last


def _inputs(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    c = SHAPE[-1]
    return (
        (3.0 + 2.0 * rng.standard_normal(SHAPE)).astype(dtype),
        (1.0 + 0.3 * rng.standard_normal(c)).astype(dtype),
        (0.3 * rng.standard_normal(c)).astype(dtype),
        rng.standard_normal(SHAPE).astype(dtype),
    )


def _plain(x, w, b, eps=1e-5):
    """The forward expression alone, for autograd to differentiate."""
    mean = x.mean(dim=(-3, -2), keepdim=True)
    var = torch.clamp((x * x).mean(dim=(-3, -2), keepdim=True) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps) * w
    return x * inv + (b - mean * inv)


def test_forward_is_the_plain_expression():
    x, w, b, _ = _inputs(0)
    got = instance_norm(*(torch.from_numpy(a) for a in (x, w, b)))
    want = _plain(*(torch.from_numpy(a) for a in (x, w, b)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_gradient_matches_float64_autograd():
    x, w, b, dy = (torch.from_numpy(a).requires_grad_() for a in _inputs(1, np.float64))
    want = torch.autograd.grad(_plain(x, w, b), (x, w, b), dy.detach())
    got = torch.autograd.grad(instance_norm(x, w, b), (x, w, b), dy.detach())
    check_grads(("x", "weight", "bias"), got, [g.numpy() for g in want], 1e-10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradient_matches_jax_custom_vjp(dtype):
    x, w, b, dy = _inputs(2)
    c = SHAPE[-1]
    bshape = (1,) * (len(SHAPE) - 1) + (c,)

    def loss(x, w, b):
        y = jax_instance_norm((-3, -2), 1e-5, x, w.reshape(bshape), b.reshape(bshape))
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy))

    jx = jnp.asarray(x).astype(dtype)
    want = [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(loss, argnums=(0, 1, 2))(jx, jnp.asarray(w), jnp.asarray(b))]

    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    tw, tb = (torch.from_numpy(a).requires_grad_() for a in (w, b))
    y = instance_norm(tx, tw, tb)
    assert y.dtype == tx.dtype
    got = torch.autograd.grad(y.float(), (tx, tw, tb), torch.from_numpy(dy))
    assert got[0].dtype == tx.dtype and got[1].dtype == torch.float32
    if dtype == "float32":
        check_grads(("x", "weight", "bias"), got, want, 2e-5)
    else:
        check_grads(("x",), got[:1], want[:1], 1e-2)
        check_grads(("weight", "bias"), got[1:], want[1:], 2e-5)


def test_module_keeps_the_input_dtype_and_not_a_float32_copy():
    """The Function saves the input in its own dtype plus per-(sample,
    channel) statistics, not a float32 copy of the map."""
    norm = InstanceNorm(SHAPE[-1])
    x = torch.randn(SHAPE, dtype=torch.bfloat16, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        norm(x).float().sum().backward()
    big = [t for t in saved if t.numel() == x.numel()]
    assert big and all(t.dtype == torch.bfloat16 for t in big)
    assert x.grad.dtype == torch.bfloat16 and norm.weight.grad.shape == (SHAPE[-1],)
