"""K1, the temporal branch: the port's plain version against the JAX
megakernel (run in interpret mode, as the JAX package's own tests run it on
the CPU) and the port's block against the JAX block's plain route.

Float32 tolerance 1e-5: the same formula on both sides, summed in another
order.  bfloat16 tolerance: both sides round at the same points (xn, qkv,
q/k, y2, out), so they differ by single bf16 ulps (2^-8 relative) where the
float32 sums before a rounding point straddle its edge; 2^-6 of the output's
largest magnitude bounds those and what they propagate into.

The kernel itself is checked against the plain version on the card by
``tests/test_torch_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.layers.attention import TemporalAttentionBlock as JaxTemporal
from bubbleformer_tpu.ops.temporal_block_mega import mega_temporal_block as jax_mega
from bubbleformer_tpu_torch.layers.attention import TemporalAttentionBlock
from bubbleformer_tpu_torch.ops.temporal_block_mega import temporal_branch_plain
from bubbleformer_tpu_torch.utils.convert import _attention_block

SHAPE = (2, 3, 8, 16, 32)
HEADS = 4


def _branch_args(shape, heads, seed):
    """Numpy inputs of the temporal branch in the JAX argument order (Dense
    kernels (in, out))."""
    rng = np.random.default_rng(seed)
    b, t, h, w, c = shape
    d = c // heads

    def n(*s, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(s)).astype(np.float32)

    return dict(
        x=n(*shape), in1_scale=n(c, scale=0.2, offset=1.0), in1_bias=n(c, scale=0.2),
        wqkv=n(c, 3 * c, scale=c**-0.5), bqkv=n(3 * c, scale=0.2),
        qn_scale=n(d, scale=0.2, offset=1.0), qn_bias=n(d, scale=0.2),
        kn_scale=n(d, scale=0.2, offset=1.0), kn_bias=n(d, scale=0.2),
        in2_scale=n(c, scale=0.2, offset=1.0), in2_bias=n(c, scale=0.2),
        wout=n(c, c, scale=c**-0.5), bout=n(c, scale=0.2),
        bias=n(heads, t, t), scale_factor=rng.uniform(0.5, 1.5, heads).astype(np.float32),
    )


def _torch_args(a, dtype=torch.float32, device="cpu"):
    """The port takes torch (out, in) weights and x in the activation dtype."""
    out = {k: torch.from_numpy(v).to(device) for k, v in a.items()}
    out["wqkv"] = out["wqkv"].t().contiguous()
    out["wout"] = out["wout"].t().contiguous()
    out["x"] = out["x"].to(dtype)
    return out


def _randomize(params, seed):
    """JAX block params with every leaf drawn at O(1) (LayerScale gamma and
    attn scale included), so the branch is not near-identity."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        if "scale" in name:
            a = 1.0 + 0.2 * a
        elif "kernel" in name:
            a = a / np.sqrt(leaf.shape[0])
        return jnp.asarray(a)

    return jax.tree_util.tree_map_with_path(draw, params)


def _port_block(module, params):
    sd = {}
    _attention_block(sd, "blk", params["params"])
    module.load_state_dict({k[len("blk."):]: v for k, v in sd.items()})
    return module.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_branch_plain_matches_jax_megakernel(dtype):
    a = _branch_args(SHAPE, HEADS, 0)
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    ja["x"] = ja["x"].astype(dtype)
    want = np.asarray(jax_mega(**ja, heads=HEADS, interpret=True).astype(jnp.float32))
    got = temporal_branch_plain(**_torch_args(a, getattr(torch, dtype)), heads=HEADS)
    assert got.dtype == getattr(torch, dtype) and got.shape == SHAPE
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2**-6 * np.abs(want).max(), err


def test_block_matches_jax_plain_route():
    """Whole block (branch, LayerScale folded into W_out, residual) against
    the JAX block's plain route, with O(1) gamma and attn scales."""
    x = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    ref = JaxTemporal(embed_dim=SHAPE[-1], num_heads=HEADS, attn_impl="plain")
    params = _randomize(ref.init(jax.random.key(0), jnp.asarray(x)), 3)
    port = _port_block(TemporalAttentionBlock(SHAPE[-1], HEADS), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want = np.asarray(ref.apply(params, jnp.asarray(x)))
    assert np.abs(want - x).max() > 0.5  # the branch is far from identity
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
