"""K6 (``fused_packed``) and K7 (``fused``), the axial attention from q, k, v
already qk-normalised, and the axial block on those two routes.

The port's plain versions against the JAX package's
``fused_axial_attention_packed`` and ``fused_axial_attention`` run in
interpret mode (as the JAX package's own tests run its Pallas kernels on the
CPU), forward and every gradient — K7's table gradients through the
autodiff of its kron packing, the port's directly — and the port's plain
backward against float64 autograd of its plain forward; then whole axial
blocks with ``attn_impl`` ``fused_packed`` and ``fused`` against the JAX
blocks.  Small widths: 2 heads of 16 or 64, token grids with h != w.

Tolerances, relative to each output's or gradient's largest magnitude:

* float32 vs JAX: 2e-5 — the same formulas in float32, summed in other
  orders;
* bfloat16 vs JAX: 2e-2 — K6 rounds P, ``dao``, ``s * dao``, ``dS`` and its
  outputs to bfloat16 (2^-8 relative) at the same points as the JAX kernel,
  K7 only each direction's output and gradients: single-ulp flips where
  reassociated float32 sums straddle a rounding edge, and what they
  propagate into;
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

from bubbleformer_tpu.layers.attention import AxialAttentionBlock as JaxAxial
from bubbleformer_tpu.ops.axial_fused import fused_axial_attention as jax_fused
from bubbleformer_tpu.ops.axial_fused_packed import fused_axial_attention_packed as jax_packed
from bubbleformer_tpu_torch.layers.attention import AxialAttentionBlock
from bubbleformer_tpu_torch.ops.axial_fused import (
    fused_axial_attention,
    fused_axial_attention_bwd,
    fused_bwd_plain,
    fused_plain,
)
from bubbleformer_tpu_torch.ops.axial_fused_packed import (
    fused_axial_attention_packed,
    fused_axial_attention_packed_bwd,
    fused_packed_bwd_plain,
    fused_packed_plain,
)
from bubbleformer_tpu_torch.utils.convert import _attention_block
from tests._torch_grads import check_grads, single_thread
from tests.test_torch_routes import _randomize

NAMES = ("q", "k", "v", "bias_x", "bias_y", "scale_x", "scale_y")
# (BT, H, W, heads, d): head dim 16 (AViT-tiny's) and 64 (every other
# config's), both with h != w.
CASES = [(2, 4, 6, 2, 16), (1, 8, 4, 2, 64)]
CASE_IDS = ["d16", "d64"]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# route -> (JAX kernel, port forward, port backward, plain forward, plain backward)
KERNELS = {
    "fused_packed": (jax_packed, fused_axial_attention_packed, fused_axial_attention_packed_bwd,
                     fused_packed_plain, fused_packed_bwd_plain),
    "fused": (jax_fused, fused_axial_attention, fused_axial_attention_bwd, fused_plain,
              fused_bwd_plain),
}


def _args(case, seed):
    """Numpy inputs (q and k as a qk-LayerNorm leaves them: O(1) rows) and
    an output gradient."""
    bt, h, w, heads, d = case
    rng = np.random.default_rng(seed)

    def n(*s):
        return rng.standard_normal(s).astype(np.float32)

    a = dict(q=n(bt, h, w, heads, d), k=n(bt, h, w, heads, d), v=n(bt, h, w, heads, d),
             bias_x=n(heads, w, w), bias_y=n(heads, h, h),
             scale_x=rng.uniform(0.5, 1.5, heads).astype(np.float32),
             scale_y=rng.uniform(0.5, 1.5, heads).astype(np.float32))
    return a, n(bt, h, w, heads, d)


def _torch(a, dtype):
    return {k: torch.from_numpy(v).to(dtype) if k in NAMES[:3] else torch.from_numpy(v)
            for k, v in a.items()}


def _jax(a, dtype):
    return {k: jnp.asarray(v).astype(dtype) if k in NAMES[:3] else jnp.asarray(v)
            for k, v in a.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("route", list(KERNELS))
def test_plain_matches_jax_interpret(route, case, dtype):
    jax_kernel, _, _, plain, _ = KERNELS[route]
    a, _ = _args(case, 0)
    want = jax_kernel(**_jax(a, dtype), interpret=True)
    assert want.dtype == jnp.dtype(dtype)
    want = np.asarray(want.astype(jnp.float32))
    got = plain(**_torch(a, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL[dtype] * np.abs(want).max(), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("route", list(KERNELS))
def test_plain_backward_matches_jax_grad(route, case, dtype):
    """Gradients of sum(out * do) through the JAX kernel in interpret mode,
    its hand-written backward included."""
    jax_kernel, _, _, _, bwd_plain = KERNELS[route]
    a, do = _args(case, 1)
    ja = _jax(a, dtype)

    def loss(*vals):
        out = jax_kernel(**dict(zip(NAMES, vals)), interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do))

    grads = jax.grad(loss, argnums=tuple(range(len(NAMES))))(*(ja[k] for k in NAMES))
    tdt = getattr(torch, dtype)
    got = bwd_plain(torch.from_numpy(do).to(tdt), **_torch(a, tdt))
    assert all(g.dtype == tdt for g in got[:3])
    check_grads(NAMES, got, [np.asarray(g.astype(jnp.float32)) for g in grads], TOL[dtype])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("route", list(KERNELS))
def test_plain_backward_matches_float64_autograd(route, case):
    _, _, _, plain, bwd_plain = KERNELS[route]
    a, do = _args(case, 2)
    ta = {k: torch.from_numpy(v).double().requires_grad_() for k, v in a.items()}
    out = plain(**ta)
    dout = torch.from_numpy(do).double()
    want = torch.autograd.grad(out, list(ta.values()), dout)
    got = bwd_plain(dout, **{k: v.detach() for k, v in ta.items()})
    check_grads(NAMES, got, [w.numpy() for w in want], 1e-9)


@pytest.mark.parametrize("route", list(KERNELS))
def test_function_takes_the_plain_versions_on_cpu(route):
    """The autograd Function runs the plain forward and differentiates
    through the plain backward on CPU tensors, counting no kernel launch;
    absent tables and scales get no gradient."""
    _, fwd, bwd, plain, bwd_plain = KERNELS[route]
    with single_thread():
        a, do = _args(CASES[0], 3)
        ta = {k: v.requires_grad_() for k, v in _torch(a, torch.float32).items()}
        before = (fwd.launches, bwd.launches)
        out = fwd(**ta)
        torch.testing.assert_close(out, plain(**ta), rtol=0, atol=0)
        got = torch.autograd.grad(out, list(ta.values()), torch.from_numpy(do))
        assert (fwd.launches, bwd.launches) == before
        want = bwd_plain(torch.from_numpy(do), **{k: v.detach() for k, v in ta.items()})
        for name, g, w in zip(NAMES, got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
        bare = [ta[k].detach() for k in NAMES[:3]]
        assert bwd(torch.from_numpy(do), *bare)[3:] == (None,) * 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", list(KERNELS))
def test_axial_block_route_matches_jax(route, dtype):
    """Whole axial block on a 6x10 grid, 2 heads of 16: the QKV Dense in the
    activation dtype, qk-LayerNorm cast back, K6 or K7 (JAX: its Pallas
    kernel in interpret mode), InstanceNorm2, the output Dense and the
    epilogue."""
    shape, heads = (2, 6, 10, 32), 2
    x = np.random.default_rng(30).standard_normal(shape).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = JaxAxial(embed_dim=32, num_heads=heads, attn_impl=route, dtype=jdt)
    init = JaxAxial(embed_dim=32, num_heads=heads, attn_impl="plain", dtype=jdt)
    params = _randomize(init.init(jax.random.key(0), jnp.asarray(x)), 31)
    sd = {}
    _attention_block(sd, "blk", params["params"])
    port = AxialAttentionBlock(32, heads, attn_impl=route, dtype=tdt)
    port.load_state_dict({k[len("blk."):]: v for k, v in sd.items()})
    want = np.asarray(ref.apply(params, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    assert np.abs(want - x).max() > 0.5  # the branch is far from identity
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL[dtype] * np.abs(want).max(), err
