"""The port's autoregressive rollout against the JAX package's ``lax.scan``
rollout: 3 windows of film_avit_tiny at 32x32, each window's prediction fed
back as the next input, and the metrics rollout that reduces each window as
it goes.

Weights start from the JAX init with LayerScale gammas, attn and feature
scales drawn at O(0.1-1) so that every block acts, and FiLM near identity.
Float32 tolerance 1e-4 of the largest magnitude: the same formula summed in
another order, carried through three windows of 4 blocks each.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.config import load_config as jax_load_config
from bubbleformer_tpu.inference import make_rollout_fn as jax_make_rollout_fn
from bubbleformer_tpu.inference import make_rollout_metrics_fn as jax_make_metrics_fn
from bubbleformer_tpu.models import get_model as jax_get_model
from bubbleformer_tpu_torch.inference import make_rollout_fn, make_rollout_metrics_fn
from bubbleformer_tpu_torch.models import build_model
from bubbleformer_tpu_torch.utils.convert import jax_params_to_state_dict

WINDOWS = 3
DATA_CFG = {"input_fields": ["dfun", "temperature", "velx", "vely"],
            "output_fields": ["dfun", "temperature", "velx", "vely"], "time_window": 5}


@pytest.fixture(scope="module")
def setup():
    cfg = jax_load_config(["model_cfg=film_avit_tiny"])["model_cfg"]
    ref = jax_get_model(cfg["name"], **cfg["params"], input_fields=4, output_fields=4,
                        time_window=5)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 5, 4, 32, 32)).astype(np.float32)
    cond = rng.standard_normal((1, 9)).astype(np.float32)
    variables = ref.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(cond))

    def act(path, leaf):
        name = jax.tree_util.keystr(path)
        if "gamma" in name:
            return jnp.asarray(rng.uniform(0.2, 0.6, leaf.shape).astype(np.float32))
        if "attn_scale" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32))
        if "freq_scalar" in name:
            return jnp.asarray(rng.uniform(-0.5, 0.5, leaf.shape).astype(np.float32))
        if "film_embed" in name and "proj" in name:
            # FiLM gamma near 1, beta near 0: the init's N(0, 1) pair makes
            # channels with |beta| >> |gamma|, whose single-pass float32
            # InstanceNorm variance (both packages use it) cancels.
            if "kernel" in name:
                return 0.1 * leaf
            c = leaf.shape[0] // 2
            return jnp.concatenate([jnp.ones(c), jnp.zeros(c)])
        return leaf

    variables = jax.tree_util.tree_map_with_path(act, variables)
    port = build_model(cfg, DATA_CFG).eval()
    port.load_state_dict(jax_params_to_state_dict(variables))
    return ref, variables, port, x, cond


def _close(got, want):
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max()
    assert err <= 1e-4 * max(np.abs(np.asarray(want)).max(), 1e-6), err


def test_rollout_matches_jax(setup):
    ref, variables, port, x, cond = setup
    want = jax_make_rollout_fn(ref, WINDOWS, conditioned=True)(
        variables, jnp.asarray(x), jnp.asarray(cond))
    got = make_rollout_fn(port, WINDOWS, conditioned=True)(torch.from_numpy(x),
                                                           torch.from_numpy(cond))
    assert got.shape == want.shape == (WINDOWS, *x.shape)
    assert np.abs(np.asarray(want[-1]) - np.asarray(want[0])).max() > 0.1  # windows differ
    for k in range(WINDOWS):
        _close(got[k].numpy(), want[k])


def test_metrics_rollout_matches_jax(setup):
    ref, variables, port, x, cond = setup
    targets = np.random.default_rng(1).standard_normal((WINDOWS, *x.shape)).astype(np.float32)
    want = jax_make_metrics_fn(ref, WINDOWS, dfun_index=0, conditioned=True)(
        variables, jnp.asarray(x), jnp.asarray(targets), jnp.asarray(cond))
    got = make_rollout_metrics_fn(port, WINDOWS, dfun_index=0, conditioned=True)(
        torch.from_numpy(x), torch.from_numpy(targets), torch.from_numpy(cond))
    assert sorted(got) == sorted(want)
    for key in got:
        assert tuple(got[key].shape) == want[key].shape, key
        if key in ("vapor_fraction", "vapor_drift"):
            # Counts of dfun > 0: a value within rounding of 0 may flip sign.
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2 / 1024)
        else:
            _close(got[key].numpy(), want[key])


def test_rollout_needs_cond_when_conditioned(setup):
    _, _, port, x, _ = setup
    with pytest.raises(ValueError, match="cond"):
        make_rollout_fn(port, 1, conditioned=True)(torch.from_numpy(x))
