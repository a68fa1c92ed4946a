"""K8 (``flash``) and the XLA ``packed`` route against the JAX package.

* K8's plain versions (``flash_plain``, ``flash_bwd_plain``: per-line float32
  attention, rounded once) against the JAX kernel run in interpret mode (it
  packs G = ``pick_flash_group`` lines with a -1e9 mask), forward and the
  gradients of q, k, v, the bias table and the scale, at (heads, M, n, d) =
  (2, 64, 5, 16), (2, 16, 32, 16) and (2, 8, 8, 64) (G = 64, 16, 8);
  the plain backward against float64 autograd; the autograd Function on CPU
  tensors;
* the port's ``packed_attention`` against JAX's in bfloat16, on the case
  where it differed from the ``plain`` route and on the ``G <= 1`` branch;
* both blocks with ``attn_impl`` ``flash`` and ``packed`` through the
  weight bridge (FiLMAViT-tiny: ``tests/test_torch_flash_model.py``); the
  temporal ``auto`` route at T = 64, which is K8.

Tolerances, relative to the largest magnitude of the reference:

* float32: 2e-5 — one function, summed in other orders (measured <= 1.3e-6
  on the kernel, 2e-6 on the models);
* K8 in bfloat16: 4e-3 (one bfloat16 ulp, 2^-8) on the output and dq, dk,
  dv — both sides compute in float32 from the same bfloat16 inputs and
  round once, so a value near a rounding midpoint lands one ulp apart
  (measured 6.2e-4); 2e-5 on the float32 bias and scale gradients;
* ``packed_attention`` in bfloat16: exact at head dim 16 (0 of 20480
  elements differ); at head dim 64 one bfloat16 ulp, 4e-3 (the 64-term
  logits are summed in other orders, and a probability near a rounding
  midpoint lands one ulp apart: 7 of 49152 elements);
* bfloat16 blocks: 2e-2, as ``tests/test_torch_routes.py`` states: both
  round every Dense, LayerNorm and InstanceNorm output, and XLA keeps some
  elementwise chains in float32 where PyTorch rounds each.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.layers.attention import AxialAttentionBlock as JaxAxial
from bubbleformer_tpu.layers.attention import TemporalAttentionBlock as JaxTemporal
from bubbleformer_tpu.ops import axial_pallas as jax_flash
from bubbleformer_tpu.ops.attention import packed_attention as jax_packed
from bubbleformer_tpu.ops.attention import pick_group_size as jax_pick_group_size
from bubbleformer_tpu_torch.layers.attention import (
    AxialAttentionBlock,
    TemporalAttentionBlock,
    resolve_temporal_impl,
)
from bubbleformer_tpu_torch.ops.attention import packed_attention, pick_group_size
from bubbleformer_tpu_torch.ops.axial_pallas import (
    flash_bwd_plain,
    flash_packed_attention,
    flash_packed_attention_bwd,
    flash_plain,
    pick_flash_group,
)
from tests._torch_grads import check_grads
from tests.test_torch_routes import _block_pair, _close

SHAPES = {"t5": (2, 64, 5, 16), "l32": (2, 16, 32, 16), "d64": (2, 8, 8, 64)}
GROUPS = {"t5": 64, "l32": 16, "d64": 8}  # the JAX kernel's packing at each shape
NAMES = ("q", "k", "v", "bias", "scale")


def _inputs(shape, seed):
    heads, _, n, _ = shape
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    bias = rng.standard_normal((heads, n, n)).astype(np.float32)
    scale = (1.0 + 0.3 * rng.uniform(-1, 1, heads)).astype(np.float32)
    return (q, k, v, bias, scale), do


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_flash_plain_matches_jax_kernel(shape, dtype):
    group, shape = GROUPS[shape], SHAPES[shape]
    (q, k, v, bias, scale), do = _inputs(shape, 1)
    _, m, n, _ = shape
    assert pick_flash_group(m, n) == jax_flash.pick_flash_group(m, n) == group
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))

    def loss(*a):
        out = jax_flash.flash_packed_attention(*a, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do))

    jargs = (jq, jk, jv, jnp.asarray(bias), jnp.asarray(scale))
    want = np.asarray(jax_flash.flash_packed_attention(*jargs, interpret=True)
                      .astype(jnp.float32))
    want_grads = [np.asarray(g.astype(jnp.float32))
                  for g in jax.grad(loss, argnums=tuple(range(5)))(*jargs)]
    targs = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    targs += [torch.from_numpy(bias), torch.from_numpy(scale)]
    got = flash_plain(*targs)
    got_grads = flash_bwd_plain(torch.from_numpy(do).to(tdt), *targs)
    assert got.dtype == tdt and all(g.dtype == tdt for g in got_grads[:3])
    tol = 2e-5 if dtype == "float32" else 4e-3
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), err
    check_grads(NAMES[:3], got_grads[:3], want_grads[:3], tol)
    check_grads(NAMES[3:], got_grads[3:], want_grads[3:], 2e-5)


def test_flash_plain_backward_matches_float64_autograd():
    """The hand-written backward against the tape, in float64 (1e-9), with
    and without the bias and the scale."""
    (q, k, v, bias, scale), do = _inputs(SHAPES["l32"], 2)
    for with_tables in (True, False):
        args = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
        tables = [torch.from_numpy(a).double().requires_grad_() for a in (bias, scale)]
        if not with_tables:
            tables = [None, None]
        out = flash_plain(*args, *tables)
        live = args + [t for t in tables if t is not None]
        want = torch.autograd.grad(out, live, torch.from_numpy(do).double())
        got = flash_bwd_plain(torch.from_numpy(do).double(), *(a.detach() for a in args),
                              *(None if t is None else t.detach() for t in tables))
        assert (got[3] is None) == (got[4] is None) == (not with_tables)
        check_grads(NAMES[:len(live)], [g for g in got if g is not None],
                    [w.numpy() for w in want], 1e-9)


def test_flash_function_takes_the_plain_versions_on_cpu():
    """``flash_packed_attention`` on CPU tensors: the plain forward and
    backward, and no kernel launch counted."""
    (q, k, v, bias, scale), do = _inputs(SHAPES["t5"], 3)
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias, scale)]
    before = (flash_packed_attention.launches, flash_packed_attention_bwd.launches)
    out = flash_packed_attention(*args)
    got = torch.autograd.grad(out, args, torch.from_numpy(do))
    assert (flash_packed_attention.launches, flash_packed_attention_bwd.launches) == before
    torch.testing.assert_close(out, flash_plain(*args), rtol=0, atol=0)
    want = flash_bwd_plain(torch.from_numpy(do), *(a.detach() for a in args))
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("shape", [(4, 64, 5, 16), (1, 53, 5, 16), (2, 12, 32, 64)],
                         ids=["queue3", "g1", "l32"])
def test_packed_matches_jax_in_bfloat16(shape):
    """(4, 64, 5, 16) with scales 1 +- 0.3 is where the ``plain`` route's
    arithmetic differed from JAX ``packed_attention`` in 3618 of 20480
    elements; 53 lines of 5 take its ``G <= 1`` branch (one head: that
    branch broadcasts the (heads, n, n) table against (heads, M, n, n))."""
    heads, m, n, _ = shape
    assert pick_group_size(m, n) == jax_pick_group_size(m, n)
    assert (pick_group_size(m, n) <= 1) == (shape[1] == 53)
    (q, k, v, bias, scale), _ = _inputs(shape, 4)
    want = np.asarray(jax_packed(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                                 jnp.asarray(bias), jnp.asarray(scale)).astype(jnp.float32))
    got = packed_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                           torch.from_numpy(bias), torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16
    if shape[-1] == 16:
        np.testing.assert_array_equal(got.float().numpy(), want)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 4e-3 * np.abs(want).max(), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["flash", "packed"])
def test_temporal_block_matches_jax(impl, dtype):
    shape, heads = (2, 5, 4, 6, 32), 2
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = JaxTemporal(embed_dim=32, num_heads=heads, attn_impl=impl, dtype=jdt)
    params, port = _block_pair(ref, TemporalAttentionBlock(32, heads, attn_impl=impl,
                                                           dtype=tdt), x, 9)
    want = np.asarray(ref.apply(params, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    assert np.abs(want - x).max() > 0.5  # the branch is far from identity
    _close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["flash", "packed"])
def test_axial_block_matches_jax(impl, dtype):
    """A 6x10 grid: rows of 10 and columns of 6 tokens."""
    shape, heads = (2, 6, 10, 32), 2
    x = np.random.default_rng(10).standard_normal(shape).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = JaxAxial(embed_dim=32, num_heads=heads, attn_impl=impl, dtype=jdt)
    params, port = _block_pair(ref, AxialAttentionBlock(32, heads, attn_impl=impl, dtype=tdt),
                               x, 11)
    want = np.asarray(ref.apply(params, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    assert np.abs(want - x).max() > 0.5
    _close(got.float().numpy(), want, dtype)


def test_temporal_auto_at_64_steps_is_flash_and_matches_jax():
    """T = 64 outside both temporal gates: ``auto`` resolves to K8, as the
    JAX resolver does on a TPU (``tests/test_torch_routes.py`` holds the
    table), and runs; the JAX block on the CPU is asked for ``flash``."""
    shape, heads = (1, 64, 4, 4, 32), 2
    assert resolve_temporal_impl("auto", *shape[1:]) == "flash"
    x = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    ref = JaxTemporal(embed_dim=32, num_heads=heads, attn_impl="flash")
    params, port = _block_pair(ref, TemporalAttentionBlock(32, heads, attn_impl="auto"), x, 13)
    want = np.asarray(ref.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert np.abs(want - x).max() > 0.5
    _close(got.numpy(), want, "float32")
