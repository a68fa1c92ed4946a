"""K9, the lane route with the QKV projection inside the kernel: the port's
plain versions (the arithmetic its CUDA kernel computes) against the JAX
package's ``lane_axial_attention_from_x(proj="kernel")``, whose Pallas
kernel runs in interpret mode, on an 8x16 token grid at head dims 8 and 16;
the axial block and a 2-block FiLMAViT with ``BUBBLEFORMER_LANE_PROJ=kernel``
against the JAX block and model (default ``remat=True``) with it.

Tolerances, relative to each gradient's largest magnitude
(``tests/_torch_grads.py``):

* float32: 1e-5, summation order only;
* bfloat16: 2e-2.  Both sides round qkv, q/k after their LN, the blended
  probabilities, ``dS``, each direction's output and ``dqkv`` and each
  direction's ``dx`` at the same points; single-ulp flips of reassociated
  float32 sums and what they propagate into remain.  ``dW`` is the float32
  sum on both sides and is not rounded to bfloat16 (where the XLA route's
  is).
"""
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.layers.attention import AxialAttentionBlock as JaxAxialBlock
from bubbleformer_tpu.models import get_model as jax_get_model
from bubbleformer_tpu.ops.axial_lane import lane_axial_attention_from_x as jax_lane
from bubbleformer_tpu_torch.layers.attention import AxialAttentionBlock
from bubbleformer_tpu_torch.models import get_model
from bubbleformer_tpu_torch.ops.axial_lane import lane_axial_attention_from_x
from bubbleformer_tpu_torch.ops.axial_lane_px import (
    lane_px_attention,
    lane_px_attention_bwd,
    lane_px_bwd_plain,
    lane_px_plain,
)
from bubbleformer_tpu_torch.utils.convert import _attention_block, jax_params_to_state_dict
from tests._torch_grads import check_grads, single_thread
from tests.test_torch_model import randomize

NAMES = ("x", "wqkv", "bqkv", "qn_scale", "qn_bias", "kn_scale", "kn_bias", "bias_x", "bias_y",
         "scale_x", "scale_y")
CASES = {"d8": (32, 4), "d16": (32, 2)}  # C, heads
KERNEL_ENV = {"BUBBLEFORMER_LANE_PROJ": "kernel"}


def _args(c, heads, seed, bt=2, h=8, w=16):
    """Numpy inputs (torch (out, in) ``wqkv``) and an output gradient."""
    rng = np.random.default_rng(seed)
    d = c // heads

    def n(*s, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(s)).astype(np.float32)

    a = dict(x=n(bt, h, w, c), wqkv=n(3 * c, c, scale=c**-0.5), bqkv=n(3 * c, scale=0.2),
             qn_scale=n(d, scale=0.2, offset=1.0), qn_bias=n(d, scale=0.2),
             kn_scale=n(d, scale=0.2, offset=1.0), kn_bias=n(d, scale=0.2),
             bias_x=n(heads, w, w), bias_y=n(heads, h, h),
             scale_x=rng.uniform(0.5, 1.5, heads).astype(np.float32),
             scale_y=rng.uniform(0.5, 1.5, heads).astype(np.float32))
    return a, n(bt, h, w, c)


def _jax_px(a, do, heads, dtype, proj="kernel"):
    """The JAX function's output (float32) and its gradients (numpy; ``wqkv``
    in torch layout) at ``dtype``."""
    ja = {k: jnp.asarray(a[k]) for k in NAMES}
    ja["wqkv"] = ja["wqkv"].T  # flax (in, out)
    ja["x"] = ja["x"].astype(dtype)

    def run(*vals):
        return jax_lane(**dict(zip(NAMES, vals)), heads=heads, interpret=True, proj=proj)

    vals = [ja[k] for k in NAMES]
    out = run(*vals)
    grads = jax.grad(lambda *v: jnp.sum(run(*v).astype(jnp.float32) * jnp.asarray(do)),
                     argnums=tuple(range(len(NAMES))))(*vals)
    want = [np.asarray(g.astype(jnp.float32)) for g in grads]
    want[1] = want[1].T
    return np.asarray(out.astype(jnp.float32)), want


@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_match_jax_kernel_in_float32(case):
    c, heads = CASES[case]
    a, do = _args(c, heads, seed=71)
    want_out, want = _jax_px(a, do, heads, "float32")
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    out = lane_px_plain(**t, heads=heads)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0,
                               atol=1e-5 * np.abs(want_out).max())
    got = lane_px_bwd_plain(torch.from_numpy(do), *t.values(), heads=heads)
    check_grads(NAMES, got, want, 1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_match_jax_kernel_in_bfloat16_with_dw_unrounded(case):
    c, heads = CASES[case]
    a, do = _args(c, heads, seed=72)
    want_out, want = _jax_px(a, do, heads, "bfloat16")
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    t["x"] = t["x"].bfloat16()
    out = lane_px_plain(**t, heads=heads)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want_out, rtol=0,
                               atol=2e-2 * np.abs(want_out).max())
    got = lane_px_bwd_plain(torch.from_numpy(do).bfloat16(), *t.values(), heads=heads)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    check_grads(NAMES, got, want, 2e-2)
    # dW: the float32 sum on both sides, which bfloat16 does not represent;
    # the XLA route's (the port's K2 route, and JAX's) is rounded.
    dw = got[1]
    assert not torch.equal(dw, dw.bfloat16().float())
    assert not np.array_equal(want[1], want[1].astype(jnp.bfloat16).astype(np.float32))
    _, want_xla = _jax_px(a, do, heads, "bfloat16", proj="xla")
    assert np.array_equal(want_xla[1], want_xla[1].astype(jnp.bfloat16).astype(np.float32))
    ta = {k: v.clone().requires_grad_() for k, v in t.items() if k != "x"}
    out_k2 = lane_axial_attention_from_x(t["x"], *ta.values(), heads=heads, proj="xla")
    (dw_k2,) = torch.autograd.grad(out_k2.float(), [ta["wqkv"]], torch.from_numpy(do))
    assert torch.equal(dw_k2, dw_k2.bfloat16().float())
    assert not torch.equal(dw, dw_k2)


def test_environment_variable_selects_k9():
    """``proj=None`` reads ``BUBBLEFORMER_LANE_PROJ``: ``kernel`` takes K9 (its
    unrounded bfloat16 dW), anything else the XLA projection and K2."""
    c, heads = CASES["d8"]
    a, do = _args(c, heads, seed=73)

    def dw(env):
        t = {k: torch.from_numpy(v).requires_grad_() for k, v in a.items() if k != "x"}
        x = torch.from_numpy(a["x"]).bfloat16()
        with mock.patch.dict(os.environ, env):
            out = lane_axial_attention_from_x(x, *t.values(), heads=heads)
        return torch.autograd.grad(out.float(), [t["wqkv"]], torch.from_numpy(do))[0]

    k9 = dw(KERNEL_ENV)
    assert not torch.equal(k9, k9.bfloat16().float())
    for env in ({"BUBBLEFORMER_LANE_PROJ": "xla"}, {"BUBBLEFORMER_LANE_PROJ": "other"}):
        k2 = dw(env)
        assert torch.equal(k2, k2.bfloat16().float()), env


def test_autograd_function_takes_the_plain_versions_on_cpu():
    with single_thread():
        c, heads = CASES["d8"]
        a, do = _args(c, heads, seed=74)
        t = {k: torch.from_numpy(v).requires_grad_() for k, v in a.items()}
        before = (lane_px_attention.launches, lane_px_attention_bwd.launches)
        out = lane_px_attention(**t, heads=heads)
        got = torch.autograd.grad(out, list(t.values()), torch.from_numpy(do))
        assert (lane_px_attention.launches, lane_px_attention_bwd.launches) == before
        want = lane_px_bwd_plain(torch.from_numpy(do), *(v.detach() for v in t.values()),
                                 heads=heads)
        for name, g, w in zip(NAMES, got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


def test_wrappers_raise_on_other_devices():
    c, heads = CASES["d8"]
    a, do = _args(c, heads, seed=75, bt=1, h=4, w=4)
    t = {k: torch.from_numpy(v).to("meta") for k, v in a.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        lane_px_attention(**t, heads=heads)
    with pytest.raises(ValueError, match="unsupported device"):
        lane_px_attention_bwd(torch.from_numpy(do).to("meta"), *t.values(), heads=heads)


def _check_param_grads(names, got, want, tol):
    """``check_grads`` over named parameters, where the gradients that are
    zero up to rounding (k-LayerNorm biases, MLP output biases, low-frequency
    scales: ``tests/test_torch_core.py`` says why) are held against a
    hundredth of the largest, as ``tests/test_torch_routes.py`` does."""
    top = max(np.abs(w).max() for w in want)
    zero = [n for n, w in zip(names, want) if np.abs(w).max() <= 1e-6 * top]
    assert all(n.endswith(("knorm.bias", "mlp.fc2.bias", "low_freq_scalar")) for n in zero), zero
    check_grads(["kn_bias" if n in zero else n for n in names], got, want, tol)


def _block_state(params):
    """A JAX axial block's parameter tree (or its gradient) by the port's
    names."""
    sd = {}
    _attention_block(sd, "blk", params["params"])
    return {k[len("blk."):]: v for k, v in sd.items()}


def test_axial_block_with_k9_matches_jax_block():
    """The port's axial block on the lane route with the variable set (K9's
    plain versions) against the JAX block with it (K9 in interpret mode),
    in float32: the output and every parameter and input gradient."""
    c, heads = 32, 4
    rng = np.random.default_rng(76)
    x = rng.standard_normal((2, 8, 16, c)).astype(np.float32)
    cot = rng.standard_normal((2, 8, 16, c)).astype(np.float32)
    blk = JaxAxialBlock(embed_dim=c, num_heads=heads, attn_impl="lane")
    params = randomize(blk.init(jax.random.key(0), jnp.asarray(x)), 77)
    with mock.patch.dict(os.environ, KERNEL_ENV):
        want_out = np.asarray(blk.apply(params, jnp.asarray(x)))
        gp, gx = jax.grad(lambda p, xx: jnp.sum(blk.apply(p, xx) * jnp.asarray(cot)),
                          argnums=(0, 1))(params, jnp.asarray(x))
        port = AxialAttentionBlock(c, heads, attn_impl="lane")
        port.load_state_dict(_block_state(params))
        xt = torch.from_numpy(x).requires_grad_()
        out = port(xt)
        out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0,
                               atol=1e-5 * np.abs(want_out).max())
    want = _block_state(gp)
    names = [n for n, _ in port.named_parameters()]
    _check_param_grads(["x"] + names, [xt.grad] + [p.grad for _, p in port.named_parameters()],
                       [np.asarray(gx)] + [want[n].numpy() for n in names], 1e-5)


def test_film_avit_with_k9_matches_jax_model_with_remat():
    """A 2-block FiLMAViT (embed 96, 6 heads of 16) on an 8x16 token grid
    with the variable set: the port's default remat ("dots") against the JAX
    model's default ``remat=True``, in float32, forward and every gradient."""
    kw = dict(input_fields=4, output_fields=4, time_window=5, patch_size=8, embed_dim=96,
              num_heads=6, processor_blocks=2, drop_path=0.0, attn_impl="lane",
              num_fluid_params=9)
    rng = np.random.default_rng(78)
    x = rng.standard_normal((1, 5, 4, 64, 128)).astype(np.float32)
    cond = rng.standard_normal((1, 9)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    ref = jax_get_model("filmavit", **kw)
    params = randomize(ref.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(cond)), 79)
    port = get_model("filmavit", **kw)
    port.load_state_dict(jax_params_to_state_dict(params))
    assert port.remat and port.remat_policy == "dots" and ref.remat
    with mock.patch.dict(os.environ, KERNEL_ENV):
        want_out = np.asarray(ref.apply(params, jnp.asarray(x), jnp.asarray(cond)))
        gp = jax.grad(lambda p: jnp.sum(ref.apply(p, jnp.asarray(x), jnp.asarray(cond))
                                        * jnp.asarray(cot)))(params)
        calls = []
        with mock.patch("bubbleformer_tpu_torch.ops.axial_lane_px.lane_px_plain",
                        side_effect=lambda *a, **k: calls.append(1) or lane_px_plain(*a, **k)):
            out = port(torch.from_numpy(x), torch.from_numpy(cond))
            (out * torch.from_numpy(cot)).sum().backward()
    assert len(calls) == 2  # once per block: the rerun reuses the kept output
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0,
                               atol=2e-5 * np.abs(want_out).max())
    want = jax_params_to_state_dict(gp)
    names = [n for n, p in port.named_parameters() if p.grad is not None]
    assert len(names) == len(list(port.parameters()))
    _check_param_grads(names, [p.grad for _, p in port.named_parameters()],
                       [want[n].numpy() for n in names], 2e-5)
