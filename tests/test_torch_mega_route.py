"""The ``mega`` route of the axial block and of a whole model: K5 in the
axial branch, K1 in the temporal one.

The mega-routed axial block against the JAX block (K5 in interpret mode on
the JAX side) and a 2-block AViT on ``attn_impl="mega"`` against the JAX
AViT (forward); three training steps on the mega route:
``tests/test_torch_mega_training.py``.  Tolerances as in
``tests/test_torch_axial_mega.py``: 2e-5 (float32) and 2e-2 (bfloat16) of
the reference's largest magnitude.  The JAX parameters are initialised
through the XLA ``plain`` route, whose parameter tree is the mega route's
(checkpoints interchange across ``attn_impl``), since an initialisation
through the Pallas kernels in interpret mode takes most of a minute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.layers.attention import AxialAttentionBlock as JaxAxial
from bubbleformer_tpu.models import get_model as jax_get_model
from bubbleformer_tpu_torch.layers.attention import AxialAttentionBlock
from bubbleformer_tpu_torch.models import build_model
from bubbleformer_tpu_torch.utils.convert import _attention_block, jax_params_to_state_dict
from tests.test_torch_routes import _randomize

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_axial_block_mega_route_matches_jax(dtype):
    """Whole axial block on a 6x10 grid, 2 heads of 16: K5 (JAX: its Pallas
    kernel in interpret mode) and the epilogue (feature scales, LayerScale,
    MLP)."""
    shape, heads = (2, 6, 10, 32), 2
    x = np.random.default_rng(20).standard_normal(shape).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = JaxAxial(embed_dim=32, num_heads=heads, attn_impl="mega", dtype=jdt)
    init = JaxAxial(embed_dim=32, num_heads=heads, attn_impl="plain", dtype=jdt)
    params = _randomize(init.init(jax.random.key(0), jnp.asarray(x)), 21)
    sd = {}
    _attention_block(sd, "blk", params["params"])
    port = AxialAttentionBlock(32, heads, attn_impl="mega", dtype=tdt)
    port.load_state_dict({k[len("blk."):]: v for k, v in sd.items()})
    want = np.asarray(ref.apply(params, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    assert np.abs(want - x).max() > 0.5  # the branch is far from identity
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL[dtype] * np.abs(want).max(), err


def _mega_avit(seed):
    """A 2-block AViT (patch 4, C=32, 2 heads of 16) on ``attn_impl="mega"``
    with 3 frames of 32x64 pixels (8x16 tokens): the JAX model and its
    params (LayerScale gammas and feature scales at O(0.5), so every block
    contributes), the port's model with the same weights and an input."""
    params_cfg = dict(patch_size=4, embed_dim=32, processor_blocks=2, num_heads=2,
                      drop_path=0.0, attn_scale=True, feat_scale=True, attn_impl="mega")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 3, 4, 32, 64)).astype(np.float32)
    ref = jax_get_model("avit", **params_cfg, input_fields=4, output_fields=4, time_window=3)
    init = jax_get_model("avit", **dict(params_cfg, attn_impl="plain"), input_fields=4,
                         output_fields=4, time_window=3)
    params = init.init(jax.random.key(0), jnp.asarray(x))

    def act(path, leaf):
        name = jax.tree_util.keystr(path)
        if "gamma" in name or "freq" in name:
            return jnp.asarray(rng.uniform(0.3, 0.7, leaf.shape).astype(np.float32))
        return leaf

    params = jax.tree_util.tree_map_with_path(act, params)
    port = build_model({"name": "avit", "params": params_cfg},
                       {"input_fields": ["f"] * 4, "output_fields": ["f"] * 4,
                        "time_window": 3})
    port.load_state_dict(jax_params_to_state_dict(params))
    return ref, params, port, x


def test_avit_mega_route_matches_jax():
    """The forward of an AViT whose temporal branches run K1 and whose axial
    branches run K5 (JAX: both Pallas kernels in interpret mode);
    the gradients through both routes are held by the three training steps
    below."""
    ref, params, port, x = _mega_avit(22)
    want = np.asarray(ref.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(want - x).max() > 0.5
    err = np.abs(out - want).max()
    assert err <= 2e-5 * np.abs(want).max(), err
