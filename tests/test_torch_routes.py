"""The routing of both attention branches by ``attn_impl``, and the routes
the port gained with it: the JAX package's XLA routes of the temporal and
the axial block, K4 (``fused_block``) inside a model, and K2 on rows longer
than one 64-token tile inside a model.

* ``resolve_temporal_impl`` and ``resolve_axial_impl`` against the JAX
  package's ``_resolve_attn_impl`` as it resolves on a TPU (its backend
  check answered "tpu"), at the token grids of the repo's configs;
* the temporal ``unrolled`` and ``plain`` routes and the axial ``plain`` and
  ``unrolled`` routes, whole blocks in float32 and bfloat16, against the JAX
  blocks with the same ``attn_impl``;
* a 2-block AViT with ``attn_impl="fused_block"`` (K4 in interpret mode on
  the JAX side) and one with ``attn_impl="lane"`` on a 2x128 token grid (K2
  in interpret mode), forward and every parameter gradient.

Tolerances, relative to the largest magnitude of the reference:

* float32: 2e-5 — one function, summed in other orders (a gradient zero up
  to rounding against a hundredth of the largest, ``tests/_torch_grads.py``);
* bfloat16 blocks: 2e-2 — both sides round the QKV Dense, q/k after their
  LayerNorm, the probabilities, the attention output, the blend, both
  InstanceNorms and the output Dense to bfloat16 (2^-8 relative); XLA may
  keep some of its elementwise chains in float32 where PyTorch rounds each
  operation, so single-ulp differences and what they propagate into
  remain.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.layers import attention as jax_attention
from bubbleformer_tpu.layers.attention import AxialAttentionBlock as JaxAxial
from bubbleformer_tpu.layers.attention import TemporalAttentionBlock as JaxTemporal
from bubbleformer_tpu.models import get_model as jax_get_model
from bubbleformer_tpu_torch.layers.attention import (
    AxialAttentionBlock,
    TemporalAttentionBlock,
    resolve_axial_impl,
    resolve_temporal_impl,
)
from bubbleformer_tpu_torch.models import build_model
from bubbleformer_tpu_torch.utils.convert import _attention_block, jax_params_to_state_dict
from tests._torch_grads import check_grads

# (T, H, W, C, heads) and the routes the JAX package takes on a TPU.
GRIDS = {
    "flow_2048x512": ((5, 32, 128, 384, 6), "core", "lane"),     # avit_small, flowboiling_chf
    "make_demo": ((5, 8, 8, 96, 6), "unrolled", "fused_block"),  # avit_tiny at 64^2
    "384px": ((5, 24, 24, 384, 6), "unrolled", "fused_block"),   # avit_small at 384^2
    "film_small_512": ((5, 32, 32, 384, 6), "mega", "lane"),
    "big_512": ((5, 32, 32, 768, 12), "core", "lane"),
    "film_small_1024": ((5, 64, 64, 384, 6), "core", "lane"),
    "rows_512": ((5, 16, 512, 384, 6), "core", "lane"),
    "rows_1024": ((5, 8, 1024, 96, 6), "core", "fused_block"),
    "t12": ((12, 8, 8, 96, 6), "plain", "fused_block"),
    "t64": ((64, 8, 8, 96, 6), "flash", "fused_block"),
}


@pytest.mark.parametrize("grid", list(GRIDS), ids=list(GRIDS))
def test_auto_resolves_as_the_jax_package_on_a_tpu(grid, monkeypatch):
    (t, h, w, c, heads), temporal, axial = GRIDS[grid]
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jax_t = jax_attention._resolve_attn_impl("auto", t, kind="temporal", shape=(t, h, w, c))
    jax_a = jax_attention._resolve_attn_impl("auto", max(h, w), kind="axial",
                                             shape=(h, w, c, heads))
    assert (jax_t, jax_a) == (temporal, axial)
    assert resolve_temporal_impl("auto", t, h, w, c) == temporal
    assert resolve_axial_impl("auto", h, w, c, heads) == axial
    for name in ("mega", "core", "plain", "unrolled", "lane", "fused_block", "packed", "flash"):
        assert resolve_temporal_impl(name, t, h, w, c) == name
        assert resolve_axial_impl(name, h, w, c, heads) == name


def _randomize(params, seed):
    """Every leaf at O(1) (LayerScale gammas, attn scales around 1), so the
    branch is far from identity."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        if ("scale" in name and "freq" not in name) or "gamma" in name:
            a = 1.0 + 0.2 * a
        elif "kernel" in name:
            a = a / np.sqrt(leaf.shape[0])
        return jnp.asarray(a)

    return jax.tree_util.tree_map_with_path(draw, params)


def _block_pair(ref, port, x, seed):
    params = _randomize(ref.init(jax.random.key(0), jnp.asarray(x)), seed)
    sd = {}
    _attention_block(sd, "blk", params["params"])
    port.load_state_dict({k[len("blk."):]: v for k, v in sd.items()})
    return params, port.eval()


def _close(got, want, dtype):
    err = np.abs(got - want).max()
    assert err <= (2e-5 if dtype == "float32" else 2e-2) * np.abs(want).max(), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["unrolled", "plain"])
def test_temporal_xla_routes_match_jax(impl, dtype):
    shape, heads = (2, 5, 4, 6, 32), 4
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
@pytest.mark.parametrize("impl", ["plain", "unrolled"])
def test_axial_xla_routes_match_jax(impl, dtype):
    """Whole axial block on a 6x10 grid: the XLA route, InstanceNorm2, the
    output Dense and the epilogue (feature scales, LayerScale, MLP)."""
    shape, heads = (2, 6, 10, 32), 4
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


def _avit_matches_jax(attn_impl, frame, embed, heads, seed):
    """A 2-block AViT (patch 4) with ``attn_impl`` on 3 frames of ``frame`` pixels:
    output and every parameter gradient against the JAX AViT with the same
    ``attn_impl``, weights through ``jax_params_to_state_dict``, LayerScale
    gammas and feature scales at O(0.5) so every block contributes."""
    cfg = {"name": "avit", "params": dict(patch_size=4, embed_dim=embed, processor_blocks=2,
                                          num_heads=heads, drop_path=0.0, attn_scale=True,
                                          feat_scale=True, attn_impl=attn_impl)}
    data_cfg = {"input_fields": ["f"] * 4, "output_fields": ["f"] * 4, "time_window": 3}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 3, 4, *frame)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    ref = jax_get_model("avit", **cfg["params"], input_fields=4, output_fields=4,
                        time_window=3)
    params = ref.init(jax.random.key(0), jnp.asarray(x))

    def act(path, leaf):
        name = jax.tree_util.keystr(path)
        if "gamma" in name or "freq" in name:
            return jnp.asarray(rng.uniform(0.3, 0.7, leaf.shape).astype(np.float32))
        return leaf

    params = jax.tree_util.tree_map_with_path(act, params)
    want_out = np.asarray(ref.apply(params, jnp.asarray(x)))
    want_grads = jax_params_to_state_dict(jax.grad(
        lambda p: jnp.sum(ref.apply(p, jnp.asarray(x)) * jnp.asarray(g)))(params))

    port = build_model(cfg, data_cfg)
    port.load_state_dict(jax_params_to_state_dict(params))
    out = port.eval()(torch.from_numpy(x))
    (out * torch.from_numpy(g)).sum().backward()
    err = np.abs(out.detach().numpy() - want_out).max()
    assert err <= 2e-5 * np.abs(want_out).max(), err
    names = [n for n, _ in port.named_parameters()]
    assert set(names) == set(want_grads)
    grads = dict(port.named_parameters())
    # Gradients zero up to rounding (every k-LayerNorm bias, each MLP's output
    # bias, each low-frequency scale: test_torch_core.py says why) against a
    # hundredth of the largest.
    top = max(np.abs(w.numpy()).max() for w in want_grads.values())
    zero = [n for n in names if np.abs(want_grads[n].numpy()).max() <= 1e-6 * top]
    assert all(n.endswith(("knorm.bias", "mlp.fc2.bias", "low_freq_scalar")) for n in zero), zero
    check_grads(["kn_bias" if n in zero else n for n in names],
                [grads[n].grad for n in names], [want_grads[n].numpy() for n in names], 2e-5)
    return port


def test_avit_fused_block_route_matches_jax():
    """8x8 tokens, 2 heads of 16: the axial branches on K4 (JAX: its Pallas
    kernel in interpret mode), the temporal ones on the XLA plain route."""
    _avit_matches_jax("fused_block", (32, 32), 32, 2, 12)


def test_avit_lane_route_on_rows_of_128_tokens_matches_jax():
    """A 2x128 token grid (8x512 px), 4 heads of 8: the axial branches on
    K2 with rows of 128 tokens (JAX: its Pallas kernel in interpret mode),
    the temporal ones on the XLA plain route."""
    _avit_matches_jax("lane", (8, 512), 32, 4, 13)
