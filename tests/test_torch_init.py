"""The port's default init against flax's, parameter by parameter.

Each model is built by the port from a seed and by the JAX package through
flax's own init, whose parameters come over through the weight bridge.  The
draws differ (torch's generator against JAX's), the distributions must not:

* a parameter flax makes constant (norm scales and biases, LayerScale
  gammas, attention scales, FiLM frequency scalars, every bias) is equal
  exactly;
* a drawn one of at least 1024 elements has a standard deviation within
  10% of flax's draw (lecun-normal kernels; the T5 table's normal(1.0));
* a kernel lies within two deviations of the normal that lecun-normal
  truncates (``layers/init.py:lecun_std``), its fan-in taken from the flax
  kernel's shape, as flax takes it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.models import get_model as jax_get_model
from bubbleformer_tpu_torch.layers.init import lecun_std
from bubbleformer_tpu_torch.models import get_model
from bubbleformer_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    unet_params_to_state_dict,
)

FIELDS = dict(input_fields=4, output_fields=4, time_window=5)
TINY = dict(patch_size=8, embed_dim=96, processor_blocks=4, num_heads=6, drop_path=0.1,
            attn_scale=True, feat_scale=True)
MODELS = {
    "filmavit": ("filmavit", dict(TINY, num_fluid_params=9)),
    "avit continuous": ("avit", dict(TINY, bias_type="continuous")),
    "unet_modern": ("unet_modern", dict(hidden_channels=8, ch_mults=[1, 2], norm=True)),
    "unet_classic": ("unet_classic", dict(hidden_channels=4)),
}


def _flax_init(name, params):
    model = jax_get_model(name, **params, **FIELDS)
    x = jnp.zeros((1, 5, 4, 32, 32))
    args = (x, jnp.zeros((1, params["num_fluid_params"]))) if name == "filmavit" else (x,)
    return jax.jit(model.init)(jax.random.key(0), *args)


def _to_state_dict(name, variables):
    if name.startswith("unet"):
        return unet_params_to_state_dict(variables)
    return jax_params_to_state_dict(variables)


@pytest.mark.parametrize("key", MODELS)
def test_port_init_draws_as_flax(key):
    name, params = MODELS[key]
    variables = _flax_init(name, params)
    want = _to_state_dict(name, variables)
    # Each kernel's fan-in, carried to the port's key by the bridge itself:
    # flax's fan-in of a kernel (..., in, out) is the product of all its
    # dims but the last.
    fan_in = _to_state_dict(name, jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, np.prod(leaf.shape[:-1]), np.float32)
        if jax.tree_util.keystr(path).endswith("['kernel']") else np.zeros(leaf.shape, np.float32),
        jax.tree.map(np.asarray, variables)))

    torch.manual_seed(0)
    got = get_model(name, **params, **FIELDS).state_dict()
    assert set(got) == set(want)
    drawn = kernels = 0
    for k, w in want.items():
        g = got[k].float().numpy()
        w = w.float().numpy()
        assert g.shape == w.shape, k
        if np.all(w == w.flat[0]):
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        drawn += 1
        if w.size >= 1024:
            assert abs(g.std() / w.std() - 1.0) < 0.1, (k, g.std(), w.std())
        n = int(fan_in[k].flatten()[0])
        if n:
            kernels += 1
            sigma = lecun_std(n)
            assert np.abs(g).max() <= 2 * sigma * (1 + 1e-6), (k, np.abs(g).max(), sigma)
            assert np.abs(w).max() <= 2 * sigma * (1 + 1e-6), (k, "flax", sigma)
    assert kernels > 0 and drawn >= kernels
    assert not [k for k in got if k.endswith(".bias") and got[k].any()], "a bias is not zero"
