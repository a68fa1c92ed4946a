"""K3, the streamed temporal core, and the core route of the temporal block.

The port's plain versions against the JAX package's ``core_temporal_attention``
run in interpret mode (as the JAX package's own tests run its Pallas kernels
on the CPU), the port's plain backward against float64 autograd, the port's
routing gates against the JAX ones, and the core-routed block and a 2-block
AViT against the JAX modules with ``attn_impl="core"``.  Small widths: C=128
(2 heads of 64), a 16x16 token grid, T=5.

Tolerances, relative to each output's or gradient's largest magnitude (a
gradient zero up to rounding, the k-LayerNorm bias's, against a hundredth
of the largest of the call; ``tests/_torch_grads.py``):

* float32 vs JAX: 2e-5 — the same formulas in float32, summed in other
  orders; the bounds ``tests/test_torch_temporal_grad.py`` holds K1 to;
* bfloat16 vs JAX: 2e-2 — both round qkv, q/k, ``ao``, ``s*dao`` and the raw
  ``dqkv`` to bfloat16 (2^-8 relative); single-ulp flips where reassociated
  float32 sums straddle a rounding edge, and what they propagate into;
* float64 plain backward vs float64 autograd: 1e-9 — one function,
  differentiated by hand and by the tape;
* whole block and 2-block AViT in float32: the float32 bound above, stated
  where each is checked.

The kernels themselves are held to these plain versions on the card by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.layers.attention import TemporalAttentionBlock as JaxTemporal
from bubbleformer_tpu.models import get_model as jax_get_model
from bubbleformer_tpu.ops import temporal_block_mega as jax_ops
from bubbleformer_tpu_torch.layers.attention import TemporalAttentionBlock, resolve_temporal_impl
from bubbleformer_tpu_torch.models import build_model
from bubbleformer_tpu_torch.ops.temporal_block_mega import (
    CORE_PARAM_NAMES,
    core_temporal_attention,
    core_temporal_attention_bwd,
    core_temporal_bwd_plain,
    core_temporal_plain,
    core_temporal_supported,
    mega_temporal_supported,
)
from bubbleformer_tpu_torch.utils.convert import jax_params_to_state_dict
from tests._torch_grads import check_grads, single_thread

SHAPE = (2, 5, 16, 16, 128)
HEADS = 2
NAMES = ("xn",) + CORE_PARAM_NAMES


def _core_args(seed, shape=SHAPE, heads=HEADS):
    """Numpy inputs in the port's layout (torch ``(3C, C)`` weight) and an
    output gradient."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    d = c // heads

    def n(*s, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(s)).astype(np.float32)

    args = dict(
        xn=n(*shape), wqkv=n(3 * c, c, scale=c**-0.5), bqkv=n(3 * c, scale=0.2),
        qn_scale=n(d, scale=0.2, offset=1.0), qn_bias=n(d, scale=0.2),
        kn_scale=n(d, scale=0.2, offset=1.0), kn_bias=n(d, scale=0.2),
        bias=n(heads, shape[1], shape[1]),
        scale_factor=rng.uniform(0.5, 1.5, heads).astype(np.float32),
    )
    return args, n(*shape)


def _torch(args, dtype):
    """Parameters float32 (float64 with float64 ``xn``), ``xn`` in ``dtype``."""
    pdt = torch.float64 if dtype == torch.float64 else torch.float32
    out = {k: torch.from_numpy(v).to(pdt) for k, v in args.items()}
    out["xn"] = out["xn"].to(dtype)
    return out


def _jax_core(args, dtype):
    ja = {k: jnp.asarray(v) for k, v in args.items()}
    ja["wqkv"] = ja["wqkv"].T  # Dense kernel (in, out)
    ja["xn"] = ja["xn"].astype(dtype)
    return ja


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_core_plain_matches_jax_interpret(dtype, tol):
    args, _ = _core_args(0)
    ja = _jax_core(args, dtype)
    want = jax_ops.core_temporal_attention(**ja, heads=HEADS, interpret=True)
    assert want.dtype == jnp.dtype(dtype)
    want = np.asarray(want.astype(jnp.float32))
    got = core_temporal_plain(**_torch(args, getattr(torch, dtype)), heads=HEADS)
    assert got.dtype == getattr(torch, dtype) and got.shape == SHAPE
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), err


def test_core_plain_backward_matches_float64_autograd():
    args, dao = _core_args(1)
    ta = {k: v.requires_grad_() for k, v in _torch(args, torch.float64).items()}
    out = core_temporal_plain(**ta, heads=HEADS)
    g = torch.from_numpy(dao).double()
    want = torch.autograd.grad(out, list(ta.values()), g)
    got = core_temporal_bwd_plain(g, **{k: v.detach() for k, v in ta.items()}, heads=HEADS)
    check_grads(NAMES, got, [w.numpy() for w in want], 1e-9)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_core_plain_backward_matches_jax_grad(dtype, tol):
    """Gradients of sum(ao * dao) through the JAX core in interpret mode,
    its hand-written backward (``_core_bwd_kernel``) included."""
    args, dao = _core_args(2)
    ja = _jax_core(args, dtype)

    def loss(*vals):
        out = jax_ops.core_temporal_attention(**dict(zip(NAMES, vals)), heads=HEADS,
                                              interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(dao))

    grads = jax.grad(loss, argnums=tuple(range(len(NAMES))))(*(ja[k] for k in NAMES))
    want = dict(zip(NAMES, (np.asarray(g.astype(jnp.float32)) for g in grads)))
    want["wqkv"] = want["wqkv"].T
    tdt = getattr(torch, dtype)
    got = core_temporal_bwd_plain(torch.from_numpy(dao).to(tdt), **_torch(args, tdt),
                                  heads=HEADS)
    assert got[0].dtype == tdt
    check_grads(NAMES, got, [want[k] for k in NAMES], tol)


def test_core_function_takes_the_plain_versions_on_cpu():
    """``core_temporal_attention`` runs the plain forward and differentiates
    through the plain backward on CPU tensors, counting no kernel launch."""
    with single_thread():
        args, dao = _core_args(3)
        ta = {k: v.requires_grad_() for k, v in _torch(args, torch.float32).items()}
        before = (core_temporal_attention.launches, core_temporal_attention_bwd.launches)
        out = core_temporal_attention(**ta, heads=HEADS)
        torch.testing.assert_close(out, core_temporal_plain(**ta, heads=HEADS), rtol=0, atol=0)
        got = torch.autograd.grad(out, list(ta.values()), torch.from_numpy(dao))
        assert (core_temporal_attention.launches,
                core_temporal_attention_bwd.launches) == before
        want = core_temporal_bwd_plain(torch.from_numpy(dao),
                                       **{k: v.detach() for k, v in ta.items()}, heads=HEADS)
        for name, g, w in zip(NAMES, got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


def test_core_absent_bias_and_scale_have_no_gradient():
    args, dao = _core_args(4)
    ta = _torch(args, torch.float32)
    ta["bias"] = ta["scale_factor"] = None
    got = core_temporal_attention_bwd(torch.from_numpy(dao), *ta.values(), heads=HEADS)
    assert got[-2] is None and got[-1] is None and got[0].shape == SHAPE


# (T, H, W, C) of the token grids BENCH_MATRIX_r05.json records, and where the
# JAX package routes their temporal branch on a TPU (attn_routing there).
GRIDS = [((5, 32, 32, 384), "mega"),   # film_avit_small at 512x512
         ((5, 32, 32, 768), "core"),   # avit_big at 512x512
         ((5, 64, 64, 384), "core"),   # film_avit_small at 1024x1024
         ((5, 128, 32, 384), "core")]  # flow boiling at 2048x512


@pytest.mark.parametrize("grid,route", GRIDS, ids=["512_c384", "512_c768", "1024_c384",
                                                  "2048x512_c384"])
def test_gates_and_route_match_jax(grid, route):
    assert mega_temporal_supported(*grid) == jax_ops.mega_temporal_supported(*grid)
    assert core_temporal_supported(*grid) == jax_ops.core_temporal_supported(*grid)
    assert resolve_temporal_impl("auto", *grid) == route
    assert resolve_temporal_impl("mega", *grid) == "mega"
    # Outside both gates (tokens not a multiple of 128) the port keeps mega.
    assert resolve_temporal_impl("auto", 5, 8, 8, grid[-1]) == "mega"


def _randomize(params, seed):
    """Every leaf at O(1) (LayerScale gamma and attn scale around 1), so the
    branch is far from identity."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        if "scale" in name or "gamma" in name:
            a = 1.0 + 0.2 * a
        elif "kernel" in name:
            a = a / np.sqrt(leaf.shape[0])
        return jnp.asarray(a)

    return jax.tree_util.tree_map_with_path(draw, params)


def test_core_block_matches_jax_core_block():
    """The port's block on the core route against the JAX block with
    ``attn_impl="core"`` (its Pallas core in interpret mode), with O(1)
    gamma and attn scales; the parameter paths are the mega route's."""
    x = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    ref = JaxTemporal(embed_dim=SHAPE[-1], num_heads=HEADS, attn_impl="core")
    params = _randomize(ref.init(jax.random.key(0), jnp.asarray(x)), 6)
    mega = JaxTemporal(embed_dim=SHAPE[-1], num_heads=HEADS, attn_impl="mega").init(
        jax.random.key(0), jnp.asarray(x))
    assert (jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(mega))

    from bubbleformer_tpu_torch.utils.convert import _attention_block

    sd = {}
    _attention_block(sd, "blk", params["params"])
    port = TemporalAttentionBlock(SHAPE[-1], HEADS, attn_impl="core")
    port.load_state_dict({k[len("blk."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(ref.apply(params, jnp.asarray(x)))
    assert np.abs(want - x).max() > 0.5  # the branch is far from identity
    # Float32, one block: the float32 bound of the module docstring.
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    # The mega route computes the same function in float32.
    port.attn_impl = "mega"
    with torch.no_grad():
        mega_out = port(torch.from_numpy(x)).numpy()
    assert np.abs(mega_out - want).max() <= 2e-5 * np.abs(want).max()


def test_avit_core_route_matches_jax_forward_and_gradients():
    """A 2-block AViT (patch 4, C=128, 2 heads) on 64x64 frames, so that the
    token grid is 16x16, with every temporal branch on the core route, against
    the JAX AViT with ``attn_impl="core"``: the output and the gradient of
    every parameter, weights through ``jax_params_to_state_dict``."""
    cfg = {"name": "avit", "params": dict(patch_size=4, embed_dim=128, processor_blocks=2,
                                          num_heads=HEADS, drop_path=0.0, attn_scale=True,
                                          feat_scale=True, attn_impl="core")}
    data_cfg = {"input_fields": ["f"] * 4, "output_fields": ["f"] * 4, "time_window": 5}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 5, 4, 64, 64)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    ref = jax_get_model("avit", **cfg["params"], input_fields=4, output_fields=4,
                        time_window=5)
    params = ref.init(jax.random.key(0), jnp.asarray(x))

    def act(path, leaf):
        """LayerScale gammas, attn and feature scales at O(0.5) so every
        block contributes."""
        name = jax.tree_util.keystr(path)
        if "gamma" in name or "freq" in name:
            return jnp.asarray(rng.uniform(0.3, 0.7, leaf.shape).astype(np.float32))
        return leaf

    params = jax.tree_util.tree_map_with_path(act, params)

    def loss(p):
        return jnp.sum(ref.apply(p, jnp.asarray(x)) * jnp.asarray(g))

    want_out = np.asarray(ref.apply(params, jnp.asarray(x)))
    want_grads = jax_params_to_state_dict(jax.grad(loss)(params))

    port = build_model(cfg, data_cfg)
    assert all(b.temporal.attn_impl == "core" for b in port.blocks)
    port.load_state_dict(jax_params_to_state_dict(params))
    out = port.eval()(torch.from_numpy(x))
    (out * torch.from_numpy(g)).sum().backward()
    # Float32 through 2 blocks, the embed and debed pyramids and ~20
    # InstanceNorms, summed in other orders.
    err = np.abs(out.detach().numpy() - want_out).max()
    assert err <= 2e-5 * np.abs(want_out).max(), err
    names = [n for n, _ in port.named_parameters()]
    assert set(names) == set(want_grads)
    grads = dict(port.named_parameters())
    # Gradients zero up to rounding (below 1e-6 of the largest) have no scale
    # of their own and are held against a hundredth of the largest: every
    # k-LayerNorm bias, each MLP's output bias (the InstanceNorm after the
    # MLP removes it) and each low-frequency scale (it shifts whole planes,
    # which the InstanceNorms downstream remove).  Measured 7e-6 at worst on
    # the others.
    top = max(np.abs(w.numpy()).max() for w in want_grads.values())
    zero = [n for n in names if np.abs(want_grads[n].numpy()).max() <= 1e-6 * top]
    assert zero and all(n.endswith(("knorm.bias", "mlp.fc2.bias", "low_freq_scalar"))
                        for n in zero), zero
    check_grads(["kn_bias" if n in zero else n for n in names],
                [grads[n].grad for n in names], [want_grads[n].numpy() for n in names], 2e-5)
