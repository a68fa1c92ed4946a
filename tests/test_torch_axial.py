"""K2, the axial row + column attention: the port's plain version against the
JAX lane kernel (run in interpret mode, as the JAX package's own tests run it
on the CPU), on a square and a non-square token grid, and the port's axial
block against the JAX block's plain route.

Float32 tolerance 1e-5 for the attention core: the same formula on both
sides, summed in another order (the block test states its own).  bfloat16
tolerance: both sides round at the same points (qkv, q/k, the blended
probabilities, each direction's output, their mean), so they differ by
single bf16 ulps where a float32 sum straddles a rounding edge; 2^-6 of the
output's largest magnitude bounds those and what they propagate into.

The kernel itself is checked against the plain version on the card by
``tests/test_torch_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.layers.attention import AxialAttentionBlock as JaxAxial
from bubbleformer_tpu.ops.axial_lane import lane_axial_attention_from_x as jax_lane
from bubbleformer_tpu_torch.layers.attention import AxialAttentionBlock
from bubbleformer_tpu_torch.ops.axial_lane import lane_axial_attention_from_x
from bubbleformer_tpu_torch.utils.convert import _attention_block

C, HEADS = 32, 4


def _args(bt, h, w, seed):
    """Numpy inputs of the lane entry in the JAX argument order."""
    rng = np.random.default_rng(seed)
    d = C // HEADS

    def n(*s, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(s)).astype(np.float32)

    return dict(
        x=n(bt, h, w, C), wqkv=n(C, 3 * C, scale=C**-0.5), bqkv=n(3 * C, scale=0.2),
        qn_scale=n(d, scale=0.2, offset=1.0), qn_bias=n(d, scale=0.2),
        kn_scale=n(d, scale=0.2, offset=1.0), kn_bias=n(d, scale=0.2),
        bias_x=n(HEADS, w, w), bias_y=n(HEADS, h, h),
        scale_x=rng.uniform(0.5, 1.5, HEADS).astype(np.float32),
        scale_y=rng.uniform(0.5, 1.5, HEADS).astype(np.float32),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grid", [(8, 8), (8, 16)], ids=["square", "nonsquare"])
def test_from_x_plain_matches_jax_lane_kernel(grid, dtype):
    a = _args(3, *grid, seed=grid[1])
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    ja["x"] = ja["x"].astype(dtype)
    want = np.asarray(jax_lane(**ja, heads=HEADS, interpret=True).astype(jnp.float32))
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    ta["x"] = ta["x"].to(getattr(torch, dtype))
    ta["wqkv"] = ta["wqkv"].t().contiguous()  # torch (out, in)
    got = lane_axial_attention_from_x(**ta, heads=HEADS)
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, *grid, C)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2**-6 * np.abs(want).max(), err


def _randomize(params, seed):
    """JAX block params with every leaf drawn at O(1) (both LayerScale
    gammas, attn and feature scales included)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        if "scale" in name and "freq" not in name:
            a = 1.0 + 0.2 * a
        elif "kernel" in name:
            a = a / np.sqrt(leaf.shape[0])
        return jnp.asarray(a)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.mark.parametrize("grid", [(8, 8), (6, 10)], ids=["square", "nonsquare"])
def test_block_matches_jax_plain_route(grid):
    """Whole block on the lane route (``auto`` takes fused_block on these
    grids, whose token counts are not multiples of 128): InstanceNorm1, the
    QKV projection and K2's autograd Function (its plain version on the
    CPU), InstanceNorm2, the output projection and the epilogue (feature
    scales, LayerScale, MLP)."""
    x = np.random.default_rng(5).standard_normal((2, *grid, C)).astype(np.float32)
    ref = JaxAxial(embed_dim=C, num_heads=HEADS, attn_impl="plain")
    params = _randomize(ref.init(jax.random.key(0), jnp.asarray(x)), 6)
    sd = {}
    _attention_block(sd, "blk", params["params"])
    port = AxialAttentionBlock(C, HEADS, attn_impl="lane").eval()
    port.load_state_dict({k[len("blk."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want = np.asarray(ref.apply(params, jnp.asarray(x)))
    assert np.abs(want - x).max() > 0.5  # the block is far from identity
    # O(1) gammas and feature scales carry float32 rounding through three
    # InstanceNorms and the MLP: on these weights the JAX package's own plain
    # and lane routes differ by up to 9e-6 of max|out|, so 2e-5 of max|out|.
    err = np.abs(got.numpy() - want).max()
    assert err <= 2e-5 * np.abs(want).max(), err
