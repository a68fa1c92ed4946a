"""Whole models on the ``flash`` (K8) and ``packed`` routes against the JAX
package, through the weight bridge: FiLMAViT-tiny (patch 8, 6 heads of 16,
4 blocks) at 64x64 with every weight at O(1), forward in float32 and
bfloat16, both branches of every block on the route (JAX's K8 in interpret
mode).

Tolerances, relative to the largest magnitude of the reference:

* float32: 2e-5 — one function, summed in other orders;
* bfloat16: 5e-2 — four blocks of O(1) residuals, each rounding every Dense,
  LayerNorm, InstanceNorm and attention output to bfloat16 on both sides at
  points XLA and PyTorch round differently; the ``plain`` and ``unrolled``
  routes measure 1.6e-2 to 3.2e-2 on this model against JAX, ``flash`` and
  ``packed`` 3.5e-2 (root mean square 2.6e-2 of the reference's for all
  four).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.config import load_config as jax_load_config
from bubbleformer_tpu.models import get_model as jax_get_model
from bubbleformer_tpu_torch.models import build_model
from bubbleformer_tpu_torch.utils.convert import jax_params_to_state_dict
from tests.test_torch_model import DATA_CFG, randomize


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["flash", "packed"])
def test_film_avit_tiny_matches_jax(impl, dtype):
    cfg = jax_load_config(["model_cfg=film_avit_tiny"])["model_cfg"]
    cfg["params"]["attn_impl"] = impl
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 5, 4, 64, 64)).astype(np.float32)
    cond = rng.standard_normal((1, 9)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    ref = jax_get_model(cfg["name"], **cfg["params"], input_fields=4, output_fields=4,
                        time_window=5, dtype=jdt)
    params = randomize(ref.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(cond)), 6)
    want = np.asarray(jax.jit(ref.apply)(params, jnp.asarray(x), jnp.asarray(cond))
                      .astype(jnp.float32))
    port = build_model(cfg, DATA_CFG, dtype).eval()
    port.load_state_dict(jax_params_to_state_dict(params))
    assert {b.temporal.attn_impl for b in port.blocks} == {impl}
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(cond))
    assert got.shape == want.shape == x.shape and got.dtype == getattr(torch, dtype)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= (2e-5 if dtype == "float32" else 5e-2) * np.abs(want).max(), err

