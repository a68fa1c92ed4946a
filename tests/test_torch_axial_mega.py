"""K5, the whole axial branch (``attn_impl="mega"``).

The port's plain versions against the JAX package's ``mega_axial_block`` run
in interpret mode (as the JAX package's own tests run its Pallas kernels on
the CPU), and the port's plain backward against float64 autograd of its
plain forward.  Small widths: 2 heads of 16 or 64, token grids with h != w.
The mega route of the axial block and of whole models:
``tests/test_torch_mega_route.py``.

Tolerances, relative to each output's or gradient's largest magnitude (a
gradient zero up to rounding, the k-LayerNorm bias's, against a hundredth of
the largest of the call; ``tests/_torch_grads.py``):

* float32 vs JAX: 2e-5 — the same formulas in float32, summed in other
  orders;
* bfloat16 vs JAX: 2e-2 — both round xn, qkv, q/k, P, y2, ``dao``,
  ``s * dao``, ``dS`` and ``dqkv`` to bfloat16 (2^-8 relative) at the same
  points: single-ulp flips where reassociated float32 sums straddle a
  rounding edge, and what they propagate into.  The port's backward also
  recomputes IN2 from the float32 ``ao`` its forward kept, where the TPU
  kernel reads a bfloat16 copy (``axial_block_mega.py:182``): its
  InstanceNorm2 and output-Dense gradients differ by up to one bfloat16
  rounding of ``ao`` carried through two InstanceNorm backwards;
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

from bubbleformer_tpu.ops.axial_block_mega import mega_axial_block as jax_mega
from bubbleformer_tpu_torch.ops.axial_block_mega import (
    PARAM_NAMES,
    mega_axial_block,
    mega_axial_block_bwd,
    mega_axial_bwd_plain,
    mega_axial_plain,
)
from tests._torch_grads import check_grads, single_thread

NAMES = ("x",) + PARAM_NAMES
# (BT, H, W, heads, d): head dim 16 (AViT-tiny's) and 64 (every other
# config's), both with h != w.
CASES = [(2, 4, 6, 2, 16), (1, 8, 4, 2, 64)]
CASE_IDS = ["d16", "d64"]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DENSE = ("wqkv", "wout")  # torch (out, in) in the port, (in, out) in JAX


def _args(case, seed):
    """Numpy inputs in the port's layout and an output gradient."""
    bt, h, w, heads, d = case
    c = heads * d
    rng = np.random.default_rng(seed)

    def n(*s, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(s)).astype(np.float32)

    a = dict(
        x=n(bt, h, w, c), in1_scale=n(c, scale=0.2, offset=1.0), in1_bias=n(c, scale=0.2),
        wqkv=n(3 * c, c, scale=c**-0.5), bqkv=n(3 * c, scale=0.2),
        qn_scale=n(d, scale=0.2, offset=1.0), qn_bias=n(d, scale=0.2),
        kn_scale=n(d, scale=0.2, offset=1.0), kn_bias=n(d, scale=0.2),
        in2_scale=n(c, scale=0.2, offset=1.0), in2_bias=n(c, scale=0.2),
        wout=n(c, c, scale=c**-0.5), bout=n(c, scale=0.2),
        bias_x=n(heads, w, w), bias_y=n(heads, h, h),
        scale_x=rng.uniform(0.5, 1.5, heads).astype(np.float32),
        scale_y=rng.uniform(0.5, 1.5, heads).astype(np.float32),
    )
    return a, n(bt, h, w, c)


def _torch(a, dtype):
    out = {k: torch.from_numpy(v) for k, v in a.items()}
    out["x"] = out["x"].to(dtype)
    return out


def _jax(a, dtype):
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    for k in DENSE:
        ja[k] = ja[k].T
    ja["x"] = ja["x"].astype(dtype)
    return ja


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_mega_plain_matches_jax_interpret(case, dtype):
    a, _ = _args(case, 0)
    want = jax_mega(**_jax(a, dtype), heads=case[3], interpret=True)
    assert want.dtype == jnp.dtype(dtype)
    want = np.asarray(want.astype(jnp.float32))
    got = mega_axial_plain(**_torch(a, getattr(torch, dtype)), heads=case[3])
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL[dtype] * np.abs(want).max(), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_mega_plain_backward_matches_jax_grad(case, dtype):
    """Gradients of sum(out * do) through the JAX kernel in interpret mode,
    its hand-written backward (``_bwd_kernel``) included."""
    a, do = _args(case, 1)
    ja = _jax(a, dtype)

    def loss(*vals):
        out = jax_mega(**dict(zip(NAMES, vals)), heads=case[3], interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do))

    grads = jax.grad(loss, argnums=tuple(range(len(NAMES))))(*(ja[k] for k in NAMES))
    want = dict(zip(NAMES, (np.asarray(g.astype(jnp.float32)) for g in grads)))
    for k in DENSE:
        want[k] = want[k].T
    tdt = getattr(torch, dtype)
    got = mega_axial_bwd_plain(torch.from_numpy(do).to(tdt), **_torch(a, tdt), heads=case[3])
    assert got[0].dtype == tdt
    check_grads(NAMES, got, [want[k] for k in NAMES], TOL[dtype])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_mega_plain_backward_matches_float64_autograd(case):
    a, do = _args(case, 2)
    ta = {k: torch.from_numpy(v).double().requires_grad_() for k, v in a.items()}
    out = mega_axial_plain(**ta, heads=case[3])
    dout = torch.from_numpy(do).double()
    want = torch.autograd.grad(out, list(ta.values()), dout)
    got = mega_axial_bwd_plain(dout, **{k: v.detach() for k, v in ta.items()}, heads=case[3])
    check_grads(NAMES, got, [w.numpy() for w in want], 1e-9)


def test_mega_function_takes_the_plain_versions_on_cpu():
    """``mega_axial_block`` runs the plain forward and differentiates through
    the plain backward on CPU tensors, counting no kernel launch; absent
    tables and scales get no gradient."""
    with single_thread():
        a, do = _args(CASES[0], 3)
        ta = {k: v.requires_grad_() for k, v in _torch(a, torch.float32).items()}
        before = (mega_axial_block.launches, mega_axial_block_bwd.launches)
        out = mega_axial_block(**ta, heads=2)
        torch.testing.assert_close(out, mega_axial_plain(**ta, heads=2), rtol=0, atol=0)
        got = torch.autograd.grad(out, list(ta.values()), torch.from_numpy(do))
        assert (mega_axial_block.launches, mega_axial_block_bwd.launches) == before
        want = mega_axial_bwd_plain(torch.from_numpy(do),
                                    **{k: v.detach() for k, v in ta.items()}, heads=2)
        for name, g, w in zip(NAMES, got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
        bare = [v.detach() for k, v in ta.items() if k not in NAMES[-4:]]
        grads = mega_axial_block_bwd(torch.from_numpy(do), *bare, heads=2)
        assert grads[-4:] == (None,) * 4
