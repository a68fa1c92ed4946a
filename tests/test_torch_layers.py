"""Parity of the PyTorch port's layers with the JAX package's.

Each test draws its inputs and weights with numpy from a seed, hands the same
arrays to the JAX module and to its counterpart in ``bubbleformer_tpu_torch``,
and compares in float32 on the CPU.  Float32 tolerances are 1e-5 (relative
and absolute): both sides compute the same formula, term for term, and differ
only in the order XLA and PyTorch sum.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from bubbleformer_tpu.layers import linear as jlinear
from bubbleformer_tpu.layers import norm as jnorm
from bubbleformer_tpu.layers import patching as jpatch
from bubbleformer_tpu.layers import positional as jpos
from bubbleformer_tpu_torch.layers import linear as tlinear
from bubbleformer_tpu_torch.layers import norm as tnorm
from bubbleformer_tpu_torch.layers import patching as tpatch
from bubbleformer_tpu_torch.layers import positional as tpos
from bubbleformer_tpu_torch.layers.stochastic import drop_path

REPO = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _randomize(params, seed):
    """Every leaf replaced by N(0, 1) draws (scales around 1), so no weight
    sits at its init value."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            a = 1.0 + 0.2 * a
        elif "kernel" in name:
            a = a / np.sqrt(np.prod(leaf.shape[:-1]))
        return jnp.asarray(a)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.mark.parametrize("qlen,klen,max_distance", [(5, 5, 32), (32, 32, 32), (8, 16, 128)])
def test_t5_bucket_table_matches_jax(qlen, klen, max_distance):
    np.testing.assert_array_equal(
        tpos.t5_bucket_table(qlen, klen, max_distance=max_distance),
        jpos.t5_bucket_table(qlen, klen, max_distance=max_distance),
    )


def test_relative_position_bias_matches_jax():
    """One table evaluated at several lengths, effective max_distance 32."""
    mod = jpos.RelativePositionBias(num_heads=4)
    params = _randomize(mod.init(jax.random.key(0), 5, 5), 1)
    port = tpos.RelativePositionBias(4)
    assert port.max_distance == 32
    with torch.no_grad():
        port.relative_attention_bias.weight.copy_(_t(params["params"]["embedding"]))
    for n in (5, 16, 40):
        np.testing.assert_array_equal(
            port(n, n).detach().numpy(), np.asarray(mod.apply(params, n, n))
        )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_matches_jax(dtype):
    """Single-pass float32 statistics, result in the input dtype.  bfloat16:
    both round the same float32 value once, so they agree to one bf16 ulp
    (2^-8 relative) where the float32 values straddle a rounding edge."""
    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.standard_normal((2, 3, 8, 8, 16))).astype(np.float32)
    mod = jnorm.InstanceNorm(16)
    params = _randomize(mod.init(jax.random.key(0), jnp.asarray(x)), 2)
    want = mod.apply(params, jnp.asarray(x).astype(dtype))
    port = tnorm.InstanceNorm(16)
    with torch.no_grad():
        port.weight.copy_(_t(params["params"]["scale"]))
        port.bias.copy_(_t(params["params"]["bias"]))
        got = port(_t(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else dict(rtol=2**-7, atol=2**-7)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_layer_norm_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 7, 16)).astype(np.float32)
    mod = nn.LayerNorm(epsilon=1e-5)  # as the JAX layers use it
    params = _randomize(mod.init(jax.random.key(0), jnp.asarray(x)), 3)
    got = tnorm.layer_norm_f32(
        _t(x), _t(params["params"]["scale"]), _t(params["params"]["bias"])
    )
    want = mod.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_gelu_mlp_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    mod = jlinear.GeluMLP(16)
    p = _randomize(mod.init(jax.random.key(0), jnp.asarray(x)), 4)["params"]
    port = tlinear.GeluMLP(16)
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            getattr(port, name).weight.copy_(_t(np.asarray(p[name]["kernel"]).T))
            getattr(port, name).bias.copy_(_t(p[name]["bias"]))
        got = port(_t(x))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(mod.apply({"params": p}, jnp.asarray(x))), **F32_TOL
    )


def test_film_mlp_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 4, 4, 16)).astype(np.float32)
    cond = rng.standard_normal((2, 9)).astype(np.float32)
    mod = jlinear.FiLMMLP(param_dim=9, embed_dim=16)
    p = _randomize(mod.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(cond)), 5)["params"]
    port = tlinear.FiLMMLP(9, 16)
    norm, proj = port.film_net
    with torch.no_grad():
        norm.weight.copy_(_t(p["norm"]["scale"]))
        norm.bias.copy_(_t(p["norm"]["bias"]))
        proj.weight.copy_(_t(np.asarray(p["proj"]["kernel"]).T))
        proj.bias.copy_(_t(p["proj"]["bias"]))
        got = port(_t(x), _t(cond))
    want = mod.apply({"params": p}, jnp.asarray(x), jnp.asarray(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_hmlp_embed_and_debed_match_jax():
    """The s2d / d2s matmul pyramids with E/4 intermediates; weights go
    through the reference torch layouts ((O, I, 2, 2) and (I, O, 2, 2))."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    emb = jpatch.HMLPEmbed(patch_size=8, in_channels=4, embed_dim=32)
    pe = _randomize(emb.init(jax.random.key(0), jnp.asarray(x)), 6)["params"]
    z = emb.apply({"params": pe}, jnp.asarray(x))
    deb = jpatch.HMLPDebed(patch_size=8, out_channels=3, embed_dim=32, emit_nchw=True)
    pd = _randomize(deb.init(jax.random.key(1), z), 7)["params"]
    y = deb.apply({"params": pd}, z)

    port_e = tpatch.HMLPEmbed(8, 4, 32)
    port_d = tpatch.HMLPDebed(8, 3, 32)
    with torch.no_grad():
        for i in range(3):
            k = np.asarray(pe[f"conv{i}"]["kernel"])  # (2, 2, I, O)
            port_e.in_proj[3 * i].weight.copy_(_t(k.transpose(3, 2, 0, 1)))
            port_e.in_proj[3 * i + 1].weight.copy_(_t(pe[f"norm{i}"]["scale"]))
            port_e.in_proj[3 * i + 1].bias.copy_(_t(pe[f"norm{i}"]["bias"]))
            k = np.asarray(pd[f"deconv{i}"]["kernel"])  # flipped (2, 2, I, O)
            port_d.out_proj[3 * i].weight.copy_(_t(k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]))
            if i < 2:
                port_d.out_proj[3 * i + 1].weight.copy_(_t(pd[f"norm{i}"]["scale"]))
                port_d.out_proj[3 * i + 1].bias.copy_(_t(pd[f"norm{i}"]["bias"]))
        got_z = port_e(_t(x))
        got_y = port_d(_t(np.asarray(z)))
    np.testing.assert_allclose(got_z.numpy(), np.asarray(z), **F32_TOL)
    assert got_y.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(y), **F32_TOL)


def test_drop_path_eval_identity_and_train_semantics():
    x = torch.ones(64, 3, 4)
    assert drop_path(x, 0.5, torch.Generator().manual_seed(0), training=False) is x
    assert drop_path(x, 0.5, None, training=True) is x
    y = drop_path(x, 0.25, torch.Generator().manual_seed(0), training=True)
    per_sample = y.reshape(64, -1)
    # Whole samples are dropped or kept, kept ones scaled by 1 / keep.
    assert torch.all((per_sample == 0).all(1) | (per_sample == 1 / 0.75).all(1))
    assert 0 < int((per_sample == 0).all(1).sum()) < 64
    y0 = drop_path(x, 0.0, torch.Generator().manual_seed(0), training=True)
    torch.testing.assert_close(y0, x)


def test_port_imports_no_jax():
    """The port's package and every module in it import no jax."""
    mods = sorted(
        "bubbleformer_tpu_torch." + ".".join(p.relative_to(REPO / "bubbleformer_tpu_torch")
                                             .with_suffix("").parts)
        for p in (REPO / "bubbleformer_tpu_torch").rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', "
        "'bubbleformer_tpu.')) or m == 'bubbleformer_tpu')\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
