"""The weight bridge ``jax_params_to_state_dict``: the exact inverse of the JAX
package's ``convert_avit_state_dict``, whose keys are the reference torch
model's and therefore the port's.

Round trip leaf by leaf (bit for bit: the bridge only transposes, flips and
reshapes), then the port's forward under bridged weights against the JAX
forward (float32, 1e-5: the same formula summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.config import load_config as jax_load_config
from bubbleformer_tpu.models import get_model as jax_get_model
from bubbleformer_tpu.utils.convert import convert_avit_state_dict
from bubbleformer_tpu_torch.models import build_model
from bubbleformer_tpu_torch.utils.convert import jax_params_to_state_dict

DATA_CFG = {"input_fields": ["dfun", "temperature", "velx", "vely"],
            "output_fields": ["dfun", "temperature", "velx", "vely"], "time_window": 5}


def _init(model_cfg, size=32):
    cfg = jax_load_config([f"model_cfg={model_cfg}"])["model_cfg"]
    model = jax_get_model(cfg["name"], **cfg["params"], input_fields=4, output_fields=4,
                          time_window=5)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 5, 4, size, size)).astype(np.float32)
    args = [jnp.asarray(x)]
    if cfg["name"] == "filmavit":
        args.append(jnp.asarray(rng.standard_normal((1, 9)).astype(np.float32)))
    return cfg, model, model.init(jax.random.key(3), *args), args


@pytest.mark.parametrize("model_cfg", ["film_avit_tiny", "avit_tiny"])
def test_round_trip_is_exact(model_cfg):
    cfg, _, variables, _ = _init(model_cfg)
    sd = jax_params_to_state_dict(variables)
    # The bridge's keys and shapes are the port model's own.
    port_sd = build_model(cfg, DATA_CFG).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in port_sd.items()
    }
    back = convert_avit_state_dict(sd, cfg["params"]["patch_size"],
                                   cfg["params"]["processor_blocks"])
    want = jax.tree_util.tree_leaves_with_path(variables["params"])
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(k) for k, _ in got] == [
        jax.tree_util.keystr(k) for k, _ in want
    ]
    for (k, a), (_, b) in zip(got, want):
        assert a.shape == b.shape, jax.tree_util.keystr(k)
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=jax.tree_util.keystr(k))


def test_forward_under_bridged_weights_matches_jax():
    cfg, model, variables, args = _init("film_avit_tiny")
    want = np.asarray(jax.jit(model.apply)(variables, *args))
    port = build_model(cfg, DATA_CFG).eval()
    port.load_state_dict(jax_params_to_state_dict(variables))
    with torch.no_grad():
        got = port(*(torch.from_numpy(np.array(a)) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
