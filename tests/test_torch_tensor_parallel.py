"""Tensor parallelism (``mesh_cfg=dp_tp``) in one process, and the refusals.

Block-level cases run a model group of two in one process: each rank is a
thread with its own sharded copy of the block (``parallel/sharding.py:
shard_model``), and the group's all-reduce sums the ranks' tensors in
float32 in rank order (:class:`ThreadGroup`).  So the sharded routes run
as they run across processes: ``copy_to_model``, the float32 partials of
the row-parallel products, the row-parallel bias on rank 0, the reduce, and
the partial-gradient class summed after the backward.  Against them, in
float32, for the ``mega`` (K1), ``core`` (K3) and ``lane`` (K2) routes with
``bias_type`` ``rel``, ``continuous`` and ``none``:

* the unsharded port block with the same weights: the output and every
  gradient (the input's, each shard's slice of its parameter's, each
  replicated parameter's) within 2e-5 of the largest magnitude;
* the JAX block (its XLA ``plain`` route, whose parameter tree every route
  shares), its parameters drawn on ``jax.eval_shape``'s tree, bridged by
  ``utils/convert.py``: within 2e-5, as ``tests/test_torch_routes.py``.

Each replicated parameter's gradient is the same bits on both ranks.  The
K1 and K3 plain versions at a rank's widths (``wqkv (3C/m, C)``, ``wout
(C, C/m)``) hold the kernels' new signature.  The four-process gloo world
(data 2 x model 2) is ``tests/test_torch_distributed.py``'s.
"""
import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.layers.attention import AxialAttentionBlock as JaxAxial
from bubbleformer_tpu.layers.attention import TemporalAttentionBlock as JaxTemporal
from bubbleformer_tpu_torch.layers.attention import AxialAttentionBlock, TemporalAttentionBlock
from bubbleformer_tpu_torch.layers.linear import GeluMLP
from bubbleformer_tpu_torch.models import build_model
from bubbleformer_tpu_torch.ops import temporal_block_mega as k13
from bubbleformer_tpu_torch.parallel.sharding import (
    ModelShard,
    all_reduce_partial_gradients,
    partial_gradient_parameters,
    shard_dim,
    shard_model,
    shard_state,
)
from bubbleformer_tpu_torch.utils.convert import _attention_block
from tests.test_torch_routes import _randomize

M = 2  # the model axis
C, HEADS = 32, 4
TEMPORAL_X = (2, 3, 4, 8, C)
AXIAL_X = (3, 4, 8, C)
# Float32 sums in other orders (the heads batched otherwise, the partials
# summed): 2e-5 of the largest magnitude, as tests/test_torch_routes.py.
TOL_PORT = TOL_JAX = 2e-5
BIAS_TYPES = ("rel", "continuous", "none")
# Gradients zero up to rounding: the k-LayerNorm bias (a shift of every key
# leaves the softmax unchanged) and the bias of the axial MLP's fc2 (the
# InstanceNorm after the MLP removes any per-channel constant).
ZERO_GRADS = ("knorm.bias", "mlp.fc2.bias", "kn_bias")


class ThreadGroup:
    """A model group of ``size`` threads in one process: ``member(rank)`` is
    that rank's all-reduce, which sums every rank's tensor in float32 in
    rank order and hands each the same sum."""

    def __init__(self, size: int):
        self.slots = [None] * size
        self.barrier = threading.Barrier(size, timeout=120)

    def member(self, rank: int):
        def all_reduce(t: torch.Tensor) -> None:
            self.slots[rank] = t.detach().clone()
            self.barrier.wait()
            total = self.slots[0].float().clone()
            for s in self.slots[1:]:
                total += s.float()
            self.barrier.wait()
            t.copy_(total.to(t.dtype))

        return all_reduce


def run_group(full: torch.nn.Module, step, size: int = M):
    """``step(rank_module, rank)`` on a sharded copy of ``full`` per rank,
    each in its own thread; returns the results in rank order (a failing
    rank's exception is raised)."""
    group = ThreadGroup(size)
    results, errors = [None] * size, []

    def run(rank):
        try:
            module = copy.deepcopy(full)
            shard = ModelShard(rank, size, group.member(rank))
            shard_model(module, shard)
            with torch.random.fork_rng(devices=[]):
                results[rank] = step(module, shard)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            group.barrier.abort()
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def forward_backward(module, x, g, shard=None):
    """Output, input gradient and parameter gradients (by name) of
    ``sum(module(x) * g)``; under a shard the partial-gradient class is
    summed over the group first, as the training module does."""
    x = x.clone().requires_grad_(True)
    out = module(x)
    (out * g).sum().backward()
    if shard is not None:
        all_reduce_partial_gradients(module, shard)
    grads = {n: p.grad.detach().clone() for n, p in module.named_parameters()}
    return out.detach(), x.grad.detach(), grads


def _close(name, got, want, tol, floor=None):
    """``got`` within ``tol`` of ``want``'s largest magnitude.  A gradient
    in ``ZERO_GRADS`` has no scale of its own, and each side's rounding is
    its own: it is held to the reference's noise, as
    ``tests/_torch_grads.py``'s ``zero_noise`` holds it (three times its
    largest magnitude, plus ``tol`` of ``floor``, a hundredth of the largest
    gradient of all)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if name in ZERO_GRADS:
        assert np.abs(got).max() <= 3 * np.abs(want).max() + tol * floor, name
        return
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, (name, err)


def _gathered(ranks, name):
    """A parameter's gradient from the ranks: the shards' slices
    concatenated, or the replicated gradient (the same bits on every
    rank)."""
    dim = shard_dim(name)
    if dim is None:
        for r in ranks[1:]:
            assert torch.equal(r[2][name], ranks[0][2][name]), name
        return ranks[0][2][name]
    return torch.cat([r[2][name] for r in ranks], dim=dim)


def _check_group(ranks, want_out, want_dx, want_grads, tol):
    """Every rank's output and input gradient the same bits and within
    ``tol`` of the reference's, every parameter's gradient (gathered) too."""
    for r in ranks:
        assert torch.equal(r[0], ranks[0][0]) and torch.equal(r[1], ranks[0][1])
    _close("out", ranks[0][0].numpy(), want_out, tol)
    _close("dx", ranks[0][1].numpy(), want_dx, tol)
    assert set(ranks[0][2]) == set(want_grads)
    floor = 1e-2 * max(np.abs(w).max() for w in want_grads.values())
    for name, want in want_grads.items():
        _close(name, _gathered(ranks, name).numpy(), want, tol, floor)


def _jax_case(kind, bias_type, impl, seed):
    """The port block (routed by ``impl``) with weights drawn on the JAX
    block's ``eval_shape`` tree, the JAX block's output and gradients
    (bridged to the port's names), the input and the output weights."""
    rng = np.random.default_rng(seed)
    shape = TEMPORAL_X if kind == "temporal" else AXIAL_X
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    cls, port_cls = ((JaxTemporal, TemporalAttentionBlock) if kind == "temporal"
                     else (JaxAxial, AxialAttentionBlock))
    ref = cls(embed_dim=C, num_heads=HEADS, attn_impl="plain", bias_type=bias_type)
    params = _randomize(jax.eval_shape(ref.init, jax.random.key(0), jnp.asarray(x)), seed + 1)

    def loss(p, xx):
        out = ref.apply(p, xx)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, out), (dparams, dx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    out = np.asarray(out)
    sd, dsd = {}, {}
    _attention_block(sd, "blk", params["params"])
    _attention_block(dsd, "blk", dparams["params"])
    port = port_cls(C, HEADS, attn_impl=impl, bias_type=bias_type)
    port.load_state_dict({k[len("blk."):]: v for k, v in sd.items()})
    want_grads = {k[len("blk."):]: v.numpy() for k, v in dsd.items()}
    return port.train(), torch.from_numpy(x), torch.from_numpy(g), out, np.asarray(dx), \
        want_grads


@pytest.mark.parametrize("bias_type", BIAS_TYPES)
@pytest.mark.parametrize("kind,impl", [("temporal", "mega"), ("temporal", "core"),
                                       ("axial", "lane")])
def test_sharded_block_matches_unsharded_and_jax(kind, impl, bias_type):
    """Two ranks of heads against the whole block, the port's and the JAX
    package's: the forward and every gradient, the partial-gradient class
    (qk-LN, the table or the continuous MLP, the attn scales, ``norm2``,
    the row-parallel biases; on ``mega`` K1's ``norm1`` and the folded
    ``gamma``) summed over the group."""
    seed = 100 + 10 * BIAS_TYPES.index(bias_type) + ("mega", "core", "lane").index(impl)
    port, x, g, jax_out, jax_dx, jax_grads = _jax_case(kind, bias_type, impl, seed)
    want_out, want_dx, want_grads = forward_backward(copy.deepcopy(port), x, g)
    _check_group([(want_out, want_dx, want_grads)], jax_out, jax_dx, jax_grads, TOL_JAX)

    def step(module, shard):
        res = forward_backward(module, x, g, shard)
        assert module._route == impl
        names = {id(p): n for n, p in module.named_parameters()}
        return res + (sorted(names[id(p)] for p in partial_gradient_parameters(module)),)

    ranks = run_group(port, step)
    _check_group(ranks, want_out.numpy(), want_dx.numpy(),
                 {n: v.numpy() for n, v in want_grads.items()}, TOL_PORT)
    _check_group(ranks, jax_out, jax_dx, jax_grads, TOL_JAX)
    partial = set(ranks[0][3])
    assert {"output_head.bias", "norm2.weight", "qnorm.weight", "knorm.bias"} <= partial
    if kind == "temporal":
        assert ({"norm1.weight", "gamma"} <= partial) == (impl == "mega")
    assert not partial & {n for n in want_grads if shard_dim(n) is not None}
    assert any(n.startswith("rel_pos_bias") for n in partial) == (bias_type != "none")


def test_sharded_mlp_matches_unsharded():
    """GeluMLP: ``fc1`` column-parallel (a rank's hidden of 4C / 2), ``fc2``
    row-parallel, its float32 partials summed and its bias on rank 0 alone,
    a partial-gradient parameter that the group's sum makes whole."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 5, C)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 5, C)).astype(np.float32))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        mlp = GeluMLP(C)
        torch.nn.init.normal_(mlp.fc2.bias)
    want_out, want_dx, want_grads = forward_backward(copy.deepcopy(mlp), x, g)

    def step(module, shard):
        assert module.fc1.weight.shape == (2 * C, C) and module.fc2.weight.shape == (C, 2 * C)
        return forward_backward(module, x, g, shard)

    ranks = run_group(mlp, step)
    _check_group(ranks, want_out.numpy(), want_dx.numpy(),
                 {n: v.numpy() for n, v in want_grads.items()}, TOL_PORT)


def _whole_k1_args(rng, c, heads, t):
    """K1's parameters for a block of ``c`` channels and ``heads`` heads."""
    d = c // heads

    def r(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape).astype(np.float32))

    return dict(in1_scale=1 + 0.2 * r(c), in1_bias=r(c), wqkv=r(3 * c, c, scale=c ** -0.5),
                bqkv=r(3 * c), qn_scale=1 + 0.2 * r(d), qn_bias=r(d), kn_scale=1 + 0.2 * r(d),
                kn_bias=r(d), in2_scale=1 + 0.2 * r(c), in2_bias=r(c),
                wout=r(c, c, scale=c ** -0.5), bout=r(c), bias=r(heads, t, t),
                scale_factor=1 + 0.2 * r(heads))


def _rank_args(p, rank, heads, c):
    """A rank's K1 arguments of ``M``: its heads' QKV rows (heads-major),
    ``norm2``'s and ``wout``'s columns of its channels, its heads' table and
    scales, no output bias."""
    hl, cl = heads // M, c // M
    hs, cs = slice(rank * hl, (rank + 1) * hl), slice(rank * cl, (rank + 1) * cl)
    rows = slice(3 * rank * cl, 3 * (rank + 1) * cl)
    return dict(p, wqkv=p["wqkv"][rows], bqkv=p["bqkv"][rows], in2_scale=p["in2_scale"][cs],
                in2_bias=p["in2_bias"][cs], wout=p["wout"][:, cs], bout=None,
                bias=p["bias"][hs], scale_factor=p["scale_factor"][hs])


# How each gradient of K1's (x, *PARAM_NAMES) and K3's (xn, *CORE_PARAM_NAMES)
# comes back from the ranks: summed (a partial gradient), or its slices
# concatenated along a dim.
_JOIN = {"wqkv": 0, "bqkv": 0, "in2_scale": 0, "in2_bias": 0, "bias": 0, "scale_factor": 0,
         "wout": 1}


def _joined(name, per_rank):
    if name in _JOIN:
        return torch.cat(per_rank, dim=_JOIN[name])
    return sum(per_rank[1:], per_rank[0])


@pytest.mark.parametrize("route", ["mega", "core"])
def test_k1_k3_plain_versions_at_a_ranks_widths(route):
    """K1's and K3's plain versions on a rank's heads (``wqkv (3C/2, C)``;
    K1's ``wout (C, C/2)``, its output a float32 partial without a bias):
    K1's two partials plus the bias, and K3's two outputs side by side,
    equal the whole function; the gradients (the input's and the shared
    norms' summed, the weights', tables' and scales' slices joined) equal
    the whole backward's."""
    rng = np.random.default_rng(11)
    b, t, hh, ww = 2, 3, 4, 4
    p = _whole_k1_args(rng, C, HEADS, t)
    x = torch.from_numpy(rng.standard_normal((b, t, hh, ww, C)).astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((b, t, hh, ww, C)).astype(np.float32))
    ranks = [_rank_args(p, r, HEADS, C) for r in range(M)]
    if route == "mega":
        names = ("x",) + k13.PARAM_NAMES
        parts = [k13.temporal_branch_plain(x, **a, heads=HEADS // M, partial=True) for a in ranks]
        assert parts[0].dtype == torch.float32 and parts[0].shape == x.shape
        got, want = parts[0] + parts[1] + p["bout"], k13.temporal_branch_plain(x, **p, heads=HEADS)
        grads = [k13.temporal_branch_bwd_plain(do, x, **a, heads=HEADS // M) for a in ranks]
        want_g = k13.temporal_branch_bwd_plain(do, x, **p, heads=HEADS)
        assert grads[0][names.index("bout")] is None
    else:
        names = ("xn",) + k13.CORE_PARAM_NAMES
        core = [{k: a[k] for k in k13.CORE_PARAM_NAMES} for a in ranks]
        whole = {k: p[k] for k in k13.CORE_PARAM_NAMES}
        parts = [k13.core_temporal_plain(x, **a, heads=HEADS // M) for a in core]
        assert parts[0].shape == (b, t, hh, ww, C // M)
        got, want = torch.cat(parts, dim=-1), k13.core_temporal_plain(x, **whole, heads=HEADS)
        dao = do.split(C // M, dim=-1)
        grads = [k13.core_temporal_bwd_plain(dao[r], x, **a, heads=HEADS // M)
                 for r, a in enumerate(core)]
        want_g = k13.core_temporal_bwd_plain(do, x, **whole, heads=HEADS)
    _close("out", got.numpy(), want.numpy(), 1e-5)
    floor = 1e-2 * max(float(w.abs().max()) for w in want_g if w is not None)
    for i, name in enumerate(names):
        if want_g[i] is None or name == "bout":
            continue
        _close(name, _joined(name, [gr[i] for gr in grads]).numpy(), want_g[i].numpy(), 1e-5,
               floor)


# ---------------------------------------------------------------------------
# What tensor parallelism refuses.

def _one_rank_group(module):
    """``module`` sharded as rank 0 of a group of two whose all-reduce is
    never reached (a refusal raises before any collective)."""
    def unreachable(t):
        raise AssertionError("a refused route reached a collective")

    return shard_model(module, ModelShard(0, M, unreachable))


@pytest.mark.parametrize("impl", ["flash", "packed", "unrolled", "plain"])
def test_temporal_routes_without_a_shard_raise(impl):
    block = _one_rank_group(TemporalAttentionBlock(C, HEADS, attn_impl=impl))
    with pytest.raises(ValueError, match=f"attn_impl='{impl}'.*mesh_cfg model=2"):
        block(torch.zeros(TEMPORAL_X))


@pytest.mark.parametrize("impl", ["mega", "fused_block", "fused_packed", "fused", "flash",
                                  "packed", "unrolled", "plain"])
def test_axial_routes_without_a_shard_raise(impl):
    block = _one_rank_group(AxialAttentionBlock(C, HEADS, attn_impl=impl))
    with pytest.raises(ValueError, match=f"attn_impl='{impl}'.*mesh_cfg model=2"):
        block(torch.zeros(AXIAL_X))


def test_lane_projection_kernel_without_a_shard_raises(monkeypatch):
    """K9 (``BUBBLEFORMER_LANE_PROJ=kernel``) has no sharded route."""
    monkeypatch.setenv("BUBBLEFORMER_LANE_PROJ", "kernel")
    block = _one_rank_group(AxialAttentionBlock(C, HEADS, attn_impl="lane"))
    with pytest.raises(ValueError, match="BUBBLEFORMER_LANE_PROJ=kernel.*mesh_cfg model=2"):
        block(torch.zeros(AXIAL_X))


@pytest.mark.parametrize("heads", [3, 5])
def test_heads_that_do_not_split_raise(heads):
    model = build_model({"name": "avit", "params": dict(patch_size=4, embed_dim=8 * heads,
                                                        num_heads=heads, processor_blocks=1)},
                        {"input_fields": ["f"] * 4, "output_fields": ["f"] * 4,
                         "time_window": 2})
    with pytest.raises(ValueError, match=f"mesh_cfg: num_heads={heads} does not split"):
        shard_model(model, ModelShard(0, M, lambda t: None))


def test_shards_are_the_whole_models_slices():
    """Every rank builds the whole model and keeps its slices: each shard
    equals the one process's slice bit for bit, the rest is untouched, and
    the state dict's slices (``shard_state``) are the shards."""
    cfg = {"name": "filmavit", "params": dict(patch_size=4, embed_dim=C, num_heads=HEADS,
                                              processor_blocks=2, num_fluid_params=9)}
    data = {"input_fields": ["f"] * 4, "output_fields": ["f"] * 4, "time_window": 2}
    torch.manual_seed(3)
    whole = build_model(cfg, data).state_dict()
    for rank in range(M):
        torch.manual_seed(3)
        model = shard_model(build_model(cfg, data), ModelShard(rank, M, lambda t: None))
        got = model.state_dict()
        assert got.keys() == whole.keys()
        sliced = shard_state(whole, ModelShard(rank, M, None))
        sharded = 0
        for k, v in got.items():
            assert torch.equal(v, sliced[k]), k
            sharded += shard_dim(k) is not None
        # each block: input_head (weight, bias) and output_head's weight in both
        # branches, the MLP's fc1 (weight, bias) and fc2's weight
        assert sharded == 2 * (3 + 3 + 3)
        assert got["blocks.0.temporal.input_head.weight"].shape == (3 * C // M, C, 1, 1)
        assert got["blocks.0.spatial.mlp.fc2.weight"].shape == (C, 4 * C // M)


# ---------------------------------------------------------------------------
# A four-process gloo world: mesh_cfg=dp_tp, data 2 x model 2.

TP_PROCESSES = 4


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    """The ranks of ``tests/_torch_dist_worker.py``'s ``tp`` scenario; while
    they run, in this process: the JAX package's single device at the global
    batch (3 AdamW steps from weights drawn on ``jax.eval_shape``'s tree)
    and the port's one process from the same weights."""
    from bubbleformer_tpu.training import ConditionedForecastModule as JaxConditionedModule
    from bubbleformer_tpu.training.module import TrainState
    from bubbleformer_tpu_torch.training import save_checkpoint
    from bubbleformer_tpu_torch.utils.convert import jax_params_to_state_dict
    from tests._torch_dist_worker import (
        ADAMW, DATA, FRAME_TP, MODEL_TP, SCHED, global_batches, tp_module, train_steps)
    from tests.test_torch_distributed import _launch
    from tests.test_torch_model import randomize

    workdir = tmp_path_factory.mktemp("tp_world")
    batches = global_batches(frame=FRAME_TP)
    ref = JaxConditionedModule(MODEL_TP, DATA, ADAMW, SCHED, total_steps=10)
    dummy = tuple(jnp.asarray(a) for a in batches[0])
    rngs = {"params": jax.random.key(0), "droppath": jax.random.key(1)}
    shapes = jax.eval_shape(lambda: ref._init_variables(rngs, dummy))
    params = randomize({"params": shapes["params"]}, 5)["params"]
    weights = jax_params_to_state_dict({"params": params})
    torch.save(weights, workdir / "jax_weights_tp.pt")
    single = tp_module()
    single.model.load_state_dict(weights)
    train_steps(single, batches[:1], generators=False)
    save_checkpoint(str(workdir / "single.pt"), single)

    launched, failed = {}, []

    def launch():
        try:
            launched["ranks"] = _launch("tp", workdir, processes=TP_PROCESSES, timeout=300)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            failed.append(e)

    world = threading.Thread(target=launch)
    world.start()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=ref.optimizer.init(params), batch_stats=None)
    step = jax.jit(ref.make_train_step())
    jax_losses = []
    for b in batches:
        state, m = step(state, tuple(jnp.asarray(a) for a in b), jax.random.key(1))
        jax_losses.append(float(m["loss"]))
    jax_final = jax_params_to_state_dict({"params": jax.tree.map(np.asarray, state.params)})
    one = tp_module()
    one.model.load_state_dict(weights)
    one_run = train_steps(one, batches, generators=False)
    world.join()
    if failed:
        raise failed[0]
    return launched["ranks"], (jax_losses, jax_final), one_run, workdir


def _whole_close(got, want, losses, want_losses):
    """``tests/test_distributed.py:98-105``'s bounds: losses rtol 2e-4 /
    atol 1e-5, every parameter within 2e-5."""
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4, atol=1e-5)
    assert got.keys() == want.keys()
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    assert worst < 2e-5, worst


def test_dp_tp_world_matches_jax(tp_world):
    """Four ranks (data 2 x model 2) against the JAX package's single device
    at the global batch: 3 AdamW steps of FiLMAViT at film_avit_tiny's
    widths, K1's and K2's plain versions on each rank's 3 heads; the
    parameters gathered whole."""
    ranks, (jax_losses, jax_final), _, _ = tp_world
    for rank, out in enumerate(ranks):
        assert out["mesh"] == (2, 2, rank // 2, rank % 2)
        assert out["ddp"] == "DistributedDataParallel"
        assert out["routes"] == [("mega", "lane")] * 2
    _whole_close(ranks[0]["whole"], jax_final, ranks[0]["losses"], jax_losses)


def test_dp_tp_world_matches_one_process(tp_world):
    ranks, _, (one_losses, one_params), _ = tp_world
    for out in ranks:
        _whole_close(out["whole"], one_params, out["losses"], one_losses)


def test_dp_tp_replicated_parameters_equal_on_every_rank(tp_world):
    """Replicated parameters the same bits on all four ranks; each shard the
    same bits on both data ranks of its model rank, and the model ranks'
    shards different."""
    ranks, _, _, _ = tp_world
    local = [out["local"] for out in ranks]
    for k, v in local[0].items():
        if shard_dim(k) is None:
            assert all(torch.equal(v, other[k]) for other in local[1:]), k
        else:
            assert torch.equal(v, local[2][k]) and torch.equal(local[1][k], local[3][k]), k
            assert not torch.equal(v, local[1][k]), k
    assert all(out["losses"] == ranks[0]["losses"] for out in ranks)


def test_dp_tp_classic_unet_global_batch_norm(tp_world):
    """ClassicUnet under dp_tp: no rule shards it, so each model rank
    computes its data rank's step; BatchNorm's statistics are the global
    batch's, summed over the data group.  As the two-process test holds it
    (``tests/test_torch_distributed.py``): outputs 1e-5 of their largest,
    gradients 1e-4 of each one's largest, statistics 1e-6; the same bits on
    the model ranks of a data rank."""
    from tests._torch_dist_worker import global_batches, unet_forward_backward, unet_module

    ranks, _, _, _ = tp_world
    want_pred, want_grads, want_stats = unet_forward_backward(unet_module(),
                                                              global_batches(1, seed=30)[0])
    scale = float(want_pred.abs().max())
    for rank, out in enumerate(ranks):
        pred, grads, stats = out["unet"]
        data_rank = rank // 2
        rows = slice(2 * data_rank, 2 * data_rank + 2)
        assert float((pred - want_pred[rows]).abs().max()) <= 1e-5 * scale
        for n, g in grads.items():
            assert float((g - want_grads[n]).abs().max()) <= 1e-4 * float(
                want_grads[n].abs().max()), n
            assert torch.equal(g, ranks[0]["unet"][1][n]), n
        for k, v in stats.items():
            torch.testing.assert_close(v, want_stats[k], rtol=1e-6, atol=1e-6)
        assert torch.equal(pred, ranks[data_rank * 2]["unet"][0])


def test_dp_tp_checkpoints_are_whole(tp_world):
    """The leader's ``last.pt`` of a dp_tp fit has the one-process format: a
    one-process module restores it (model and AdamW moments), every rank
    restores its slices of it bit for bit, and every rank restores its
    slices of a one-process checkpoint."""
    from tests._torch_dist_worker import tp_module
    from bubbleformer_tpu_torch.training import load_checkpoint, restore_checkpoint

    ranks, _, _, workdir = tp_world
    ckpt = load_checkpoint(str(workdir / "tp_fit" / "last.pt"))
    one = tp_module()
    want = one.model.state_dict()
    assert ckpt["model"].keys() == want.keys()
    assert all(ckpt["model"][k].shape == v.shape for k, v in want.items())
    restore_checkpoint(str(workdir / "tp_fit" / "last.pt"), one)
    assert one.step == 2
    single = load_checkpoint(str(workdir / "single.pt"))
    for rank, out in enumerate(ranks):
        shard = ModelShard(rank % 2, 2, None)
        for k, v in shard_state(ckpt["model"], shard).items():
            assert torch.equal(v, out["fit_local"][k]), (rank, k)
        assert out["restored_equal"] and out["restored_moments_equal"]
        for k, v in shard_state(single["model"], shard).items():
            assert torch.equal(v, out["from_single"][k]), (rank, k)
        assert out["from_single_step"] == single["step"] == 1
    exp_avg = one.optimizer.state_dict()["state"]
    assert exp_avg and all(s["exp_avg"].shape == p.shape
                           for s, p in zip(exp_avg.values(), one.model.parameters()))
