"""``bias_type`` in the port against the JAX package: the continuous MLP bias
alone, both attention blocks with ``"continuous"`` and ``"none"`` on the
routes the CPU runs (the kernels' plain versions behind their autograd
Functions), three training steps of a 2-block FiLMAViT, and the weight
bridge for all three types.

The JAX side runs its XLA ``plain`` route: its routes share one parameter
tree and agree with each other (the JAX package's own tests), and its Pallas
kernels in interpret mode would take minutes here.  Inputs and weights come
from seeded numpy draws over the JAX parameter tree's shapes
(``jax.eval_shape``: flax's eager initialisation alone takes half a minute
here); weights cross through the bridge.

Tolerances:

* the continuous table: 1e-6 relative (float32; the 512-term product in
  another order); the MLP's gradients 1e-5 of each one's largest magnitude;
* blocks: the output 1e-5 of its largest magnitude, every gradient 2e-5 of
  its own (``tests/_torch_grads.py``), float32 in another summation order,
  as ``tests/test_torch_axial_grad.py`` and ``tests/test_torch_temporal_grad.py``
  hold the kernels' gradients against JAX's.  Two gradients are zero up to
  rounding (``ZERO``), and the two sides' rounding noise is uncorrelated
  (other formulas, not only another order), so each is held to the
  reference's own noise (``check_grads(zero_noise=True)``).  The attn-scale
  gradients sum ``(p - 1/n) g`` over every line, terms that cancel to a few
  hundredths of the block's largest gradient: JAX's own float32 one lies
  5.7e-5 from float64 on the axial block here, so they are held to 2e-4 (in
  float64 the port's routes agree with each other to 1e-13);
* three training steps: losses 1e-5 relative, parameters 1e-5 relative plus
  2e-6, as ``tests/test_torch_training.py`` holds them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.layers.attention import AxialAttentionBlock as JaxAxial
from bubbleformer_tpu.layers.attention import TemporalAttentionBlock as JaxTemporal
from bubbleformer_tpu.layers.positional import ContinuousPositionBias1D as JaxContinuous
from bubbleformer_tpu.layers.positional import make_bias_module as jax_make_bias_module
from bubbleformer_tpu.models import get_model as jax_get_model
from bubbleformer_tpu.training import ConditionedForecastModule as JaxConditionedModule
from bubbleformer_tpu.training.module import TrainState
from bubbleformer_tpu.utils.convert import convert_avit_state_dict
from bubbleformer_tpu_torch.data import synthetic_batch
from bubbleformer_tpu_torch.layers.attention import AxialAttentionBlock, TemporalAttentionBlock
from bubbleformer_tpu_torch.layers.positional import ContinuousPositionBias1D, make_bias_module
from bubbleformer_tpu_torch.models import get_model
from bubbleformer_tpu_torch.training import ConditionedForecastModule
from bubbleformer_tpu_torch.utils.convert import _attention_block, jax_params_to_state_dict
from tests._torch_grads import check_grads
from tests.test_torch_model import randomize
from tests.test_torch_routes import _randomize
from tests.test_torch_training import ADAMW, DATA_CFG, SCHED, TINY

C, HEADS = 32, 2
# (B, T, H, W, C) for the temporal block, (B*T, H, W, C) for the axial one:
# 8x16 tokens, two heads of 16.
SHAPES = {"temporal": (2, 3, 8, 16, C), "axial": (2, 8, 16, C)}
BLOCKS = {"temporal": (JaxTemporal, TemporalAttentionBlock),
          "axial": (JaxAxial, AxialAttentionBlock)}
# The routes each block takes on the CPU: the XLA route, and the kernels'
# autograd Functions (K1 mega and K3 core; K5 mega and K2 lane).
ROUTES = {"temporal": ("plain", "mega", "core"), "axial": ("plain", "mega", "lane")}
# Gradients that are zero up to rounding: the k-LayerNorm bias (a shift of
# every key leaves each softmax row unchanged) and the axial MLP's output
# bias (the InstanceNorm after the MLP removes each channel's constant).
ZERO = ("knorm.bias", "mlp.fc2.bias")


@pytest.mark.parametrize("n", [5, 8, 32])
def test_continuous_bias_matches_jax(n):
    rng = np.random.default_rng(n)
    heads, hidden = 3, 512
    params = {"fc1": {"kernel": rng.standard_normal((1, hidden)).astype(np.float32),
                      "bias": (0.1 * rng.standard_normal(hidden)).astype(np.float32)},
              "fc2": {"kernel": (rng.standard_normal((hidden, heads)) / hidden**0.5)
                      .astype(np.float32)}}
    g = rng.standard_normal((heads, n, n)).astype(np.float32)
    ref = JaxContinuous(num_heads=heads)

    def loss(p):
        table = ref.apply({"params": p}, n, n)
        return jnp.sum(table * g), table

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))

    port = ContinuousPositionBias1D(heads)
    port.load_state_dict(_mlp_state(params))
    got = port(n, n)
    assert got.shape == (heads, n, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6)
    assert 0.0 < float(got.detach().min()) and float(got.detach().max()) < 16.0
    (got * torch.from_numpy(g)).sum().backward()
    gsd = _mlp_state(jax.tree.map(np.asarray, jgrads))
    names = list(gsd)
    check_grads(names, [dict(port.named_parameters())[k].grad for k in names],
                [gsd[k].numpy() for k in names], 1e-5)


def _mlp_state(mlp):
    """The module's state dict from a ``ContinuousPositionBias1D`` subtree
    (Dense kernels ``(I, O)`` -> Linear weights ``(O, I)``; the bridge's own
    map is held by the block and round-trip tests)."""
    return {"cpb_mlp.0.weight": torch.from_numpy(np.asarray(mlp["fc1"]["kernel"]).T.copy()),
            "cpb_mlp.0.bias": torch.from_numpy(np.asarray(mlp["fc1"]["bias"])),
            "cpb_mlp.2.weight": torch.from_numpy(np.asarray(mlp["fc2"]["kernel"]).T.copy())}


@functools.lru_cache(maxsize=None)
def _jax_block(kind, bias_type):
    """The JAX block on its XLA route: (params, x, output gradient, output,
    gradients of the params and of x), from seeded draws."""
    shape = SHAPES[kind]
    rng = np.random.default_rng(len(shape) * 10 + len(bias_type))
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    ref = BLOCKS[kind][0](embed_dim=C, num_heads=HEADS, bias_type=bias_type, attn_impl="plain")
    params = _randomize(jax.eval_shape(ref.init, jax.random.key(0), jnp.asarray(x)),
                        len(bias_type))

    def loss(p, xx):
        out = ref.apply(p, xx)
        return jnp.sum(out * g), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    return params, x, g, np.asarray(out), jax.tree.map(np.asarray, gp), np.asarray(gx)


@pytest.mark.parametrize("bias_type", ["continuous", "none"])
@pytest.mark.parametrize("kind,route", [(k, r) for k in ROUTES for r in ROUTES[k]])
def test_block_matches_jax(kind, route, bias_type):
    params, x, g, want, gparams, gx = _jax_block(kind, bias_type)
    port = BLOCKS[kind][1](C, HEADS, attn_impl=route, bias_type=bias_type)
    sd = {}
    _attention_block(sd, "blk", params["params"])
    port.load_state_dict({k[len("blk."):]: v for k, v in sd.items()})
    xt = torch.from_numpy(x).requires_grad_()
    out = port.eval()(xt)
    assert np.abs(want - x).max() > 0.5  # the branch is far from identity
    err = np.abs(out.detach().numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err
    out.backward(torch.from_numpy(g))

    gsd = {}
    _attention_block(gsd, "blk", gparams["params"])
    named = dict(port.named_parameters())
    names = [k[len("blk."):] for k in gsd]
    assert sorted(names) == sorted(named)
    assert any("cpb_mlp" in k for k in names) == (bias_type == "continuous")
    assert not any("rel_pos_bias" in k for k in names) or bias_type != "none"
    # check_grads takes the name "kn_bias" for a gradient zero up to rounding.
    for group, tol in ((lambda n: "attn_scale" not in n, 2e-5),
                       (lambda n: "attn_scale" in n, 2e-4)):
        chosen = [n for n in names if group(n)]
        check_grads(["x"] + ["kn_bias" if n in ZERO else n for n in chosen],
                    [xt.grad] + [named[n].grad for n in chosen],
                    [gx] + [gsd["blk." + n].numpy() for n in chosen], tol, zero_noise=True)


@pytest.mark.parametrize("bias_type", ["continuous", "none"])
def test_three_train_steps_match_jax(bias_type):
    """Three AdamW steps of a 2-block FiLMAViT (C=32, 4 heads of 8) on 32x64
    frames, 8x16 tokens: the port's default routes (``auto``: K1's and K2's
    autograd Functions, asserted by ``tests/test_torch_training.py``) against
    the JAX ``ConditionedForecastModule`` on its plain route without remat
    (which changes no value: ``tests/test_torch_remat.py``; it halves JAX's
    compile here), from the same bridged weights on the same batches.
    AdamW's eps is 1e-3 for the reason ``tests/test_torch_training.py``
    gives."""
    params_cfg = dict(TINY["params"], embed_dim=32, bias_type=bias_type)
    port_cfg = {"name": "filmavit", "params": params_cfg}
    jax_cfg = {"name": "filmavit", "params": dict(params_cfg, attn_impl="plain", remat=False)}
    batches = [synthetic_batch(2, 2, 4, 32, 64, num_fluid_params=9, seed=i) for i in range(3)]
    adamw = {"name": "adamw", "params": dict(ADAMW["params"], eps=1e-3)}
    ref = JaxConditionedModule(jax_cfg, DATA_CFG, adamw, SCHED, total_steps=10)
    b0 = tuple(jnp.asarray(a) for a in batches[0])
    params = randomize(jax.eval_shape(ref.model.init, jax.random.key(0), b0[0], b0[2]),
                       4)["params"]
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=ref.optimizer.init(params))
    step = jax.jit(ref.make_train_step())
    want_losses = []
    for b in batches:
        state, m = step(state, tuple(jnp.asarray(a) for a in b), jax.random.key(1))
        want_losses.append(float(m["loss"]))

    port = ConditionedForecastModule(port_cfg, DATA_CFG, adamw, SCHED, total_steps=10,
                                     device="cpu")
    port.model.load_state_dict(jax_params_to_state_dict({"params": params}))
    got = [port.train_step(tuple(torch.from_numpy(a) for a in b), None) for b in batches]
    np.testing.assert_allclose([float(m["loss"]) for m in got], want_losses, rtol=1e-5)
    want = jax_params_to_state_dict({"params": jax.tree.map(np.asarray, state.params)})
    assert any("cpb_mlp" in k for k in want) == (bias_type == "continuous")
    for name, p in port.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-5, atol=2e-6,
                                   err_msg=name)
    mlp = [p for n, p in port.model.named_parameters() if "cpb_mlp" in n]
    assert all(p.grad is not None and bool(p.grad.any()) for p in mlp)


@pytest.mark.parametrize("bias_type", ["rel", "continuous", "none"])
def test_bridge_round_trip(bias_type):
    """JAX params -> the port's state dict (loaded strictly) -> JAX's own
    ``convert_avit_state_dict`` gives every leaf back."""
    cfg = dict(patch_size=4, embed_dim=16, num_heads=2, processor_blocks=2, bias_type=bias_type)
    ref = jax_get_model("filmavit", **cfg, attn_impl="plain", input_fields=4, output_fields=4,
                        time_window=2, num_fluid_params=9)
    x = jnp.zeros((1, 2, 4, 16, 16))
    variables = jax.eval_shape(ref.init, jax.random.key(1), x, jnp.zeros((1, 9)))
    params = jax.tree.map(np.asarray, randomize(variables, 3)["params"])
    port = get_model("filmavit", **cfg, input_fields=4, output_fields=4, time_window=2,
                     num_fluid_params=9)
    port.load_state_dict(jax_params_to_state_dict({"params": params}), strict=True)
    back = convert_avit_state_dict(port.state_dict(), patch_size=4, processor_blocks=2)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=jax.tree_util.keystr(path))
    has = {"rel": "RelativePositionBias_0", "continuous": "ContinuousPositionBias1D_0"}
    for block in ("temporal", "spatial"):
        mods = {k for k in params["block0"][block] if "PositionBias" in k}
        assert mods == ({has[bias_type]} if bias_type in has else set())


def test_none_has_no_bias_parameters_and_unknown_types_raise():
    model = get_model("avit", patch_size=4, embed_dim=16, num_heads=2, processor_blocks=2,
                      bias_type="none")
    assert not [k for k in model.state_dict() if "rel_pos_bias" in k]
    assert all(b.temporal.rel_pos_bias is None and b.spatial.rel_pos_bias is None
               for b in model.blocks)
    assert make_bias_module("none", 2) is None and jax_make_bias_module("none", 2) is None
    for make in (make_bias_module, jax_make_bias_module):
        with pytest.raises(ValueError, match="Unknown bias_type: t5"):
            make("t5", 2)
    with pytest.raises(ValueError, match="Unknown bias_type: t5"):
        get_model("avit", patch_size=4, embed_dim=16, num_heads=2, processor_blocks=1,
                  bias_type="t5")
