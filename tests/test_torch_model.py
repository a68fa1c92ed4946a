"""The port's whole model and its configuration against the JAX package's.

``FiLMAViT`` film_avit_tiny (patch 8, embed 96, 6 heads, 4 blocks) at 64x64
with every weight drawn at O(1) — LayerScale gammas, attn and feature scales
and T5 tables included, since the init gammas of 1e-6 would make every block
near-identity — goes through the JAX model (whose ``auto`` routes are the
plain/unrolled ones on the CPU, pinned equal to the mega and lane kernels by
the JAX package's golden tests) and through the port, with the same numpy
inputs, on 64x64 frames (the XLA unrolled and fused_block routes) and on
64x128 (the mega and lane routes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.config import load_config as jax_load_config
from bubbleformer_tpu.models import get_model as jax_get_model
from bubbleformer_tpu_torch.config import FILM_AVIT_SMALL, load_config
from bubbleformer_tpu_torch.layers.attention import resolve_axial_impl, resolve_temporal_impl
from bubbleformer_tpu_torch.models import build_model
from bubbleformer_tpu_torch.utils.convert import jax_params_to_state_dict

DATA_CFG = {"input_fields": ["dfun", "temperature", "velx", "vely"],
            "output_fields": ["dfun", "temperature", "velx", "vely"], "time_window": 5}


def test_film_avit_small_dict_equals_yaml():
    assert FILM_AVIT_SMALL == jax_load_config(["model_cfg=film_avit_small"])["model_cfg"]


@pytest.mark.parametrize("overrides", [
    [],
    ["model_cfg=film_avit_tiny", "data_cfg=samples_smoke", "batch_size=3",
     "optim_cfg.params.lr=0.1"],
])
def test_config_loader_matches_jax(overrides, monkeypatch):
    """The port composes its own copy of the YAML files exactly as the JAX
    loader composes the originals, the device mesh included."""
    monkeypatch.setenv("BUBBLEML_DIR", "/data/bubbleml")
    want = jax_load_config(overrides)
    assert want["mesh_cfg"] == {"data": -1, "model": 1}
    assert load_config(overrides) == want
    assert load_config(overrides + ["mesh_cfg=single"]) == want


def randomize(params, seed):
    """Every leaf at O(1): gammas and scales around 1, feature scales and T5
    tables N(0, 1), kernels lecun-normal, so no block is near-identity."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        a = rng.standard_normal(leaf.shape)
        if "gamma" in name or ("scale" in name and "freq" not in name):
            a = 1.0 + 0.2 * a
        elif "kernel" in name:
            a = a / np.sqrt(np.prod(leaf.shape[:-1]))
        elif "bias" in name and "embedding" not in name:
            a = 0.1 * a
        return jnp.asarray(a.astype(np.float32))

    params = jax.tree_util.tree_map_with_path(draw, params)
    if "film_embed" in params["params"]:
        # FiLM gamma around 1 and beta small.  With both N(0, 1), channels
        # with |beta| >> |gamma| make the next InstanceNorm's single-pass
        # float32 variance (both packages use it) cancel, and float32 itself
        # rather than the port limits the comparison.
        proj = params["params"]["film_embed"]["proj"]
        c = proj["bias"].shape[0] // 2
        proj["kernel"] = 0.1 * proj["kernel"]
        proj["bias"] = jnp.concatenate([jnp.ones(c), jnp.zeros(c)]) + 0.1 * proj["bias"]
    return params


def test_film_avit_tiny_matches_jax():
    cfg = jax_load_config(["model_cfg=film_avit_tiny"])["model_cfg"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 64, 64)).astype(np.float32)
    cond = rng.standard_normal((2, 9)).astype(np.float32)
    ref = jax_get_model(cfg["name"], **cfg["params"], input_fields=4, output_fields=4,
                        time_window=5)
    params = randomize(ref.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(cond)), 1)
    want = np.asarray(jax.jit(ref.apply)(params, jnp.asarray(x), jnp.asarray(cond)))

    port = build_model(cfg, DATA_CFG).eval()
    port.load_state_dict(jax_params_to_state_dict(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(cond))
    assert got.shape == want.shape == x.shape
    # Float32 rounding carried through 4 blocks of O(1)-gamma residuals and
    # ~30 InstanceNorms, summed in other orders: measured 2e-6 of max|out|.
    err = np.abs(got.numpy() - want).max()
    assert err <= 2e-5 * np.abs(want).max(), err


def test_film_avit_tiny_on_the_kernel_routes_matches_jax():
    """film_avit_tiny on 64x128 frames: an 8x16 token grid (128 tokens)
    inside the megakernel's and the lane kernel's gates, so ``auto`` takes
    the mega route (K1's plain version) and the lane route (K2's) in every
    block, as FiLMAViT-small does at 512x512; the 64x64 frames of
    ``test_film_avit_tiny_matches_jax`` (8x8 tokens) take the XLA unrolled
    route and fused_block (K4) instead.  The JAX model on the CPU takes its
    XLA routes: the same function in float32."""
    cfg = jax_load_config(["model_cfg=film_avit_tiny"])["model_cfg"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 5, 4, 64, 128)).astype(np.float32)
    cond = rng.standard_normal((1, 9)).astype(np.float32)
    ref = jax_get_model(cfg["name"], **cfg["params"], input_fields=4, output_fields=4,
                        time_window=5)
    params = randomize(ref.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(cond)), 4)
    want = np.asarray(jax.jit(ref.apply)(params, jnp.asarray(x), jnp.asarray(cond)))
    port = build_model(cfg, DATA_CFG).eval()
    port.load_state_dict(jax_params_to_state_dict(params))
    block = port.blocks[0]
    assert resolve_temporal_impl(block.temporal.attn_impl, 5, 8, 16, 96) == "mega"
    assert resolve_axial_impl(block.spatial.attn_impl, 8, 16, 96, 6) == "lane"
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(cond))
    # The float32 bound of test_film_avit_tiny_matches_jax.
    err = np.abs(got.numpy() - want).max()
    assert err <= 2e-5 * np.abs(want).max(), err


def test_build_model_mirrors_module_wiring():
    """``build_model`` takes field counts and the time window from the data
    config and the activation dtype from ``compute_dtype``; parameters stay
    float32."""
    cfg = load_config(["model_cfg=avit_tiny"])
    model = build_model(cfg["model_cfg"], DATA_CFG, compute_dtype="bfloat16")
    assert type(model).__name__ == "AViT" and model.dtype == torch.bfloat16
    assert model.output_fields == 4 and len(model.blocks) == cfg["model_cfg"]["params"][
        "processor_blocks"]
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    x = torch.randn(1, 5, 4, 32, 32)
    with torch.no_grad():
        y = model.eval()(x)
    assert y.shape == x.shape and y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
