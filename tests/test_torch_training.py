"""The port's training path against the JAX package's: schedules, optimizers,
the criterion, drop-path, three train steps of a tiny FiLMAViT, and the
trainer's checkpoint, resume, preemption and failure paths.

Tolerances are stated where they are checked.  The three-step comparison
runs under AdamW with drop-path 0: Lion's ``sign()`` flips wherever its
argument is near 0, so a comparison under Lion would hold parameters only
to whole units of ``lr``; the random drop-path bits of the two packages
differ (``test_drop_path_takes_the_masks_it_is_given`` holds the masks
themselves).
"""
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bubbleformer_tpu.layers.stochastic import drop_path as jax_drop_path
from bubbleformer_tpu.training import ConditionedForecastModule as JaxConditionedModule
from bubbleformer_tpu.training.optim import make_optimizer as jax_make_optimizer
from bubbleformer_tpu.utils.losses import LpLoss as JaxLpLoss
from bubbleformer_tpu.utils.schedulers import make_schedule as jax_make_schedule
from bubbleformer_tpu_torch.data import synthetic_batch
from bubbleformer_tpu_torch.layers.attention import resolve_axial_impl, resolve_temporal_impl
from bubbleformer_tpu_torch.layers.stochastic import drop_path
from bubbleformer_tpu_torch.training import (
    ConditionedForecastModule,
    ForecastModule,
    Trainer,
    load_checkpoint,
    make_optimizer,
    next_preempt_ckpt_path,
    restore_checkpoint,
    save_checkpoint,
)
from bubbleformer_tpu_torch.utils.convert import jax_params_to_state_dict
from bubbleformer_tpu_torch.utils.losses import LpLoss
from bubbleformer_tpu_torch.utils.schedulers import make_schedule
from tests._torch_grads import single_thread
from tests.test_torch_model import randomize

TINY = {"name": "filmavit", "params": {"patch_size": 4, "embed_dim": 24, "num_heads": 4,
                                       "processor_blocks": 2, "drop_path": 0.0,
                                       "num_fluid_params": 9}}
DATA_CFG = {"input_fields": ["dfun", "temperature", "velx", "vely"],
            "output_fields": ["dfun", "temperature", "velx", "vely"], "time_window": 2}
ADAMW = {"name": "adamw", "params": {"lr": 1e-3, "weight_decay": 1e-2}}
SCHED = {"name": "cosine_warmup", "params": {"warmup_iters": 2, "eta_min": 1e-6}}


@pytest.mark.parametrize("name,params", [
    ("cosine", {"eta_min": 1e-6}),
    ("cosine_warmup", {"warmup_iters": 5, "eta_min": 1e-6}),
    ("cosine_warmup", {"warmup_iters": 0}),
    ("constant", {}),
])
def test_schedules_match_jax(name, params):
    """Float64 here against JAX's float32: 1e-6 relative, or 1e-6 of the
    base rate near the cosine's floor."""
    want = jax_make_schedule(name, 2.5e-4, 40, **params)
    got = make_schedule(name, 2.5e-4, 40, **params)
    steps = range(0, 45)
    np.testing.assert_allclose([got(s) for s in steps], [float(want(s)) for s in steps],
                               rtol=1e-6, atol=2.5e-10)
    if name == "cosine_warmup" and params["warmup_iters"]:
        assert got(0) == 0.0 and got(5) == pytest.approx(2.5e-4)


@pytest.mark.parametrize("name", ["adamw", "adam", "lion"])
def test_optimizer_steps_match_optax(name):
    """Three updates on identical parameters and gradients against the JAX
    package's ``make_optimizer`` (optax): float32 rounding of the same
    update, 1e-6 of the parameters."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    lr, wd = 1e-3, 1e-2

    opt = jax_make_optimizer(name, lr, weight_decay=wd)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(params)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    topt = make_optimizer(name, list(tparams.values()), lr=lr, weight_decay=wd)
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_training_criterion_matches_jax():
    rng = np.random.default_rng(1)
    pred, tgt = (rng.standard_normal((3, 2, 4, 8, 8)).astype(np.float32) for _ in range(2))
    kw = dict(d=2, p=2, reduce_dims=[0, 1, 2], reductions=["mean", "mean", "sum"])
    want = float(JaxLpLoss(**kw)(jnp.asarray(pred), jnp.asarray(tgt)))
    got = float(LpLoss(**kw)(torch.from_numpy(pred), torch.from_numpy(tgt)))
    assert got == pytest.approx(want, rel=1e-6)


def test_drop_path_takes_the_masks_it_is_given():
    """JAX's keep mask, handed to the port, gives JAX's output exactly; a
    generator's masks are reproducible from its seed."""
    x = np.random.default_rng(2).standard_normal((8, 3, 4)).astype(np.float32)
    rate = 0.4
    jax_out = np.asarray(jax_drop_path(jnp.asarray(x), rate, jax.random.key(3), False))
    keep = np.abs(jax_out).sum(axis=(1, 2)) > 0
    assert 0 < keep.sum() < len(keep)
    got = drop_path(torch.from_numpy(x), rate, None, True, mask=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=1e-6)

    def draw(seed):
        return drop_path(torch.ones(64, 2), rate, torch.Generator().manual_seed(seed), True)

    torch.testing.assert_close(draw(5), draw(5), rtol=0, atol=0)
    assert not torch.equal(draw(5), draw(6))
    assert torch.equal(drop_path(torch.ones(4, 2), rate, None, False), torch.ones(4, 2))


def _three_train_steps_match_jax(model_cfg, frame):
    """Three AdamW steps of ``model_cfg`` on ``frame``-pixel batches, the
    port against the JAX ``ConditionedForecastModule`` train step, with the
    tolerances of :func:`test_three_train_steps_match_jax`."""
    batches = [synthetic_batch(2, 2, 4, *frame, num_fluid_params=9, seed=i) for i in range(3)]
    adamw = {"name": "adamw", "params": dict(ADAMW["params"], eps=1e-3)}
    ref = JaxConditionedModule(model_cfg, DATA_CFG, adamw, SCHED, total_steps=10)
    state = ref.init_state(jax.random.key(0), batches[0])
    params = randomize({"params": state.params}, 4)["params"]
    state = state.replace(params=params, opt_state=ref.optimizer.init(params))
    step = jax.jit(ref.make_train_step())
    want_losses, want_lrs = [], []
    for b in batches:
        state, m = step(state, tuple(jnp.asarray(a) for a in b), jax.random.key(1))
        want_losses.append(float(m["loss"]))
        want_lrs.append(float(m["learning_rate"]))

    port = ConditionedForecastModule(model_cfg, DATA_CFG, adamw, SCHED, total_steps=10,
                                     device="cpu")
    port.model.load_state_dict(jax_params_to_state_dict({"params": params}))
    got = [port.train_step(tuple(torch.from_numpy(a) for a in b), None) for b in batches]
    np.testing.assert_allclose([float(m["loss"]) for m in got], want_losses, rtol=1e-5)
    np.testing.assert_allclose([m["learning_rate"] for m in got], want_lrs, rtol=1e-6)
    assert want_lrs[0] == 0.0 and port.step == 3

    want = jax_params_to_state_dict({"params": jax.tree.map(np.asarray, state.params)})
    moved = 0
    for name, p in port.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-5, atol=2e-6,
                                   err_msg=name)
        moved += int(not np.array_equal(want[name].numpy(),
                                        jax_params_to_state_dict({"params": params})[name]))
    assert moved > 0.9 * len(want)
    return port


def test_three_train_steps_match_jax():
    """Three AdamW steps of a tiny FiLMAViT (O(1) gammas and scales) from
    the same bridged weights on the same batches, against the JAX
    ``ConditionedForecastModule`` train step (plain routes on the CPU), on
    16x16 frames: 4x4 tokens, so ``auto`` takes the XLA unrolled route and
    fused_block (K4's plain version).
    Losses 1e-5 relative: float32 through 2 blocks and ~20 InstanceNorms.
    Parameters within 2e-6 + 1e-5 relative.  AdamW's first updates are
    ``lr * g / (|g| + eps)``: some gradients are zero up to rounding noise
    (the v part of the QKV bias: the InstanceNorm2 backward sums to zero
    over each plane), and with the default eps of 1e-8 AdamW would scale
    that noise to whole units of ``lr`` on both sides; eps 1e-3 keeps noise
    of 1e-6 below 1e-3 ``lr`` and leaves the real gradients' updates near
    ``lr``."""
    _three_train_steps_match_jax(TINY, (16, 16))


def test_three_train_steps_on_the_kernel_routes_match_jax():
    """The same three steps on 32x64 frames, an 8x16 token grid (128 tokens)
    with head dim 8: inside the megakernel's and the lane kernel's gates, so
    ``auto`` takes the mega and lane routes, and the forward and backward of
    K1's and K2's autograd Functions (their plain versions on the CPU) are
    held against JAX's train step.  Same tolerances."""
    cfg = {"name": "filmavit", "params": dict(TINY["params"], embed_dim=32)}
    port = _three_train_steps_match_jax(cfg, (32, 64))
    block = port.model.blocks[0]
    assert resolve_temporal_impl(block.temporal.attn_impl, 2, 8, 16, 32) == "mega"
    assert resolve_axial_impl(block.spatial.attn_impl, 8, 16, 32, 4) == "lane"


class ListLoader:
    def __init__(self, batches, on_yield=None):
        self.batches = batches
        self.on_yield = on_yield

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if self.on_yield is not None:
                self.on_yield(i)
            yield b


def _module(drop_path_rate=0.2, optim=ADAMW):
    cfg = {"name": "avit", "params": dict(TINY["params"], drop_path=drop_path_rate)}
    del cfg["params"]["num_fluid_params"]
    return ForecastModule(cfg, DATA_CFG, optim, SCHED, total_steps=8, device="cpu",
                          normalization_constants=({"dfun": 1.5}, {"dfun": 2.5}))


def _batches(n):
    return [synthetic_batch(2, 2, 4, 16, 16, seed=10 + i) for i in range(n)]


def test_checkpoint_round_trip_and_resume_equal_an_uninterrupted_run(tmp_path):
    """Drop-path 0.2 and Lion: a run resumed from its epoch-0 checkpoint ends
    bit-equal to one that never stopped (the masks are drawn per step)."""
    with single_thread():
        lion = {"name": "lion", "params": {"lr": 1e-4, "weight_decay": 0.1}}
        loader = ListLoader(_batches(2))
        first = Trainer(_module(optim=lion), log_dir=str(tmp_path / "a"), limit_val_batches=1)
        first.fit(loader, ListLoader(_batches(1)), max_epochs=1)
        ckpt = str(tmp_path / "a" / "last.pt")
        saved = load_checkpoint(ckpt)
        assert saved["step"] == 2 and saved["format_version"] == 1
        assert saved["norm_constants"] == ({"dfun": 1.5}, {"dfun": 2.5})
        for k, v in first.module.model.state_dict().items():
            torch.testing.assert_close(saved["model"][k], v, rtol=0, atol=0)

        resumed = Trainer(_module(optim=lion), log_dir=str(tmp_path / "b"))
        resumed.module.normalization_constants = None
        resumed.fit(loader, max_epochs=2, ckpt_path=ckpt)
        assert resumed.module.step == 4
        assert resumed.module.normalization_constants == ({"dfun": 1.5}, {"dfun": 2.5})
        straight = Trainer(_module(optim=lion), log_dir=str(tmp_path / "c"))
        straight.fit(loader, max_epochs=2)
        for (k, v), w in zip(resumed.module.model.state_dict().items(),
                             straight.module.model.state_dict().values()):
            torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
        rows = open(tmp_path / "a" / "metrics.csv").read().splitlines()
        assert rows[0] == "step,epoch,split,loss,learning_rate" and ",val," in rows[-1]


def test_a_restore_that_fails_raises(tmp_path):
    module = _module()
    good = str(tmp_path / "good.pt")
    save_checkpoint(good, module)
    bad = str(tmp_path / "not_a_checkpoint.pt")
    torch.save({"weights": torch.zeros(3)}, bad)
    with pytest.raises(ValueError, match="not a checkpoint"):
        restore_checkpoint(bad, module)
    other = ConditionedForecastModule(
        {"name": "filmavit", "params": dict(TINY["params"], embed_dim=32)},
        DATA_CFG, ADAMW, SCHED, total_steps=8, device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        restore_checkpoint(good, other)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "missing.pt"), module)


def test_sigterm_saves_at_the_step_boundary(tmp_path):
    """SIGTERM while the loader yields the second batch: the run stops at a
    step boundary (one early with the prefetch lookahead) with a numbered
    checkpoint that resumes at that step."""
    def kill(i):
        if i == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    preempt = next_preempt_ckpt_path(str(tmp_path), None)
    assert preempt.endswith("hpc_ckpt_1.pt")
    trainer = Trainer(_module(), log_dir=str(tmp_path), preempt_ckpt_path=preempt)
    try:
        module = trainer.fit(ListLoader(_batches(4), on_yield=kill), max_epochs=3)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert 1 <= module.step <= 2 and os.path.exists(preempt)
    again = _module()
    restore_checkpoint(preempt, again)
    assert again.step == module.step
    assert next_preempt_ckpt_path(str(tmp_path), preempt).endswith("hpc_ckpt_2.pt")


def test_non_finite_loss_stops_the_run_and_leaves_a_snapshot(tmp_path):
    batches = _batches(3)
    batches[1] = (np.full_like(batches[1][0], np.nan), batches[1][1])
    trainer = Trainer(_module(), log_dir=str(tmp_path), log_every=1)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        trainer.fit(ListLoader(batches), max_epochs=1)
    snapshot = load_checkpoint(str(tmp_path / "non_finite_state.pt"))
    assert snapshot["step"] == 2
