"""K10 (the training criterion's plane norms) and the channels-last loss
against the JAX package.

* ``training_lp_loss`` on CPU tensors (K10's plain versions through its
  autograd Function) against the JAX kernel in interpret mode, value and
  prediction gradient, as ``tests/test_losses.py`` runs it, with a float32
  and a bfloat16 prediction; against the port's ``LpLoss`` criterion; the
  Function counts no launch on the CPU and gives the target no gradient;
* the models' ``output_layout="nhwc"`` decode: the same values, channels
  last;
* ``loss_layout="nhwc"`` against ``"nchw"`` in the port's module (one step:
  loss and every gradient), and three steps against the JAX module with the
  same layout; the layout's validation and the warning for a model without
  a channels-last decode; ``BUBBLEFORMER_LOSS_KERNEL=1`` leaves CPU
  predictions on the criterion.

Tolerances, relative: the loss 1e-6 (float32 plane sums in other orders);
the prediction gradient 1e-5 of its largest magnitude (float32), one
bfloat16 ulp, 4e-3, for a bfloat16 prediction, whose gradient both sides
round once; the layouts' gradients 1e-5 of each gradient's largest
magnitude (the same float32 function, its (H, W) sums addressed
differently); the three steps as ``tests/test_torch_training.py`` states.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.ops.lp_loss import training_lp_loss as jax_training_lp_loss
from bubbleformer_tpu_torch.data import synthetic_batch
from bubbleformer_tpu_torch.models import FiLMAViT, build_model
from bubbleformer_tpu_torch.ops.lp_loss import (
    plane_norms,
    plane_norms_bwd,
    plane_norms_bwd_plain,
    plane_norms_plain,
    training_lp_loss,
)
from bubbleformer_tpu_torch.training import ConditionedForecastModule, ForecastModule
from bubbleformer_tpu_torch.utils.losses import LpLoss
from tests._torch_grads import check_grads
from tests.test_torch_training import ADAMW, DATA_CFG, SCHED, TINY, _three_train_steps_match_jax

SHAPE = (2, 3, 4, 16, 24)


def _pred_tgt(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_lp_loss_matches_jax_kernel(dtype):
    pred, tgt = _pred_tgt(17)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp, jt = jnp.asarray(pred).astype(jdt), jnp.asarray(tgt)
    want = float(jax_training_lp_loss(jp, jt))
    want_g = np.asarray(jax.grad(lambda p: jax_training_lp_loss(p, jt))(jp).astype(jnp.float32))
    p = torch.from_numpy(pred).to(tdt).requires_grad_()
    got = training_lp_loss(p, torch.from_numpy(tgt))
    got.backward()
    assert got.dtype == torch.float32 and p.grad.dtype == tdt
    assert float(got.detach()) == pytest.approx(want, rel=1e-6)
    err = np.abs(p.grad.float().numpy() - want_g).max()
    assert err <= (1e-5 if dtype == "float32" else 4e-3) * np.abs(want_g).max(), err


def test_training_lp_loss_matches_the_criterion():
    """K10's path and ``LpLoss(d=2, p=2, [0, 1, 2], [mean, mean, sum])``: the
    same function (value 1e-6, gradient 1e-5)."""
    pred, tgt = _pred_tgt(18)
    crit = LpLoss(d=2, p=2, reduce_dims=[0, 1, 2], reductions=["mean", "mean", "sum"])
    a, b = (torch.from_numpy(pred).requires_grad_() for _ in range(2))
    va, vb = training_lp_loss(a, torch.from_numpy(tgt)), crit(b, torch.from_numpy(tgt))
    va.backward()
    vb.backward()
    assert float(va.detach()) == pytest.approx(float(vb.detach()), rel=1e-6)
    err = (a.grad - b.grad).abs().max() / b.grad.abs().max()
    assert err <= 1e-5, float(err)


def test_plane_norms_function_takes_the_plain_versions_on_cpu():
    pred, tgt = (torch.from_numpy(a).reshape(24, -1) for a in _pred_tgt(19))
    pred.requires_grad_()
    tgt.requires_grad_()
    before = (plane_norms.launches, plane_norms_bwd.launches)
    out = plane_norms(pred, tgt)
    g = torch.from_numpy(np.random.default_rng(20).standard_normal((24, 2)).astype(np.float32))
    dpred, dtgt = torch.autograd.grad(out, [pred, tgt], g, allow_unused=True)
    assert (plane_norms.launches, plane_norms_bwd.launches) == before
    torch.testing.assert_close(out, plane_norms_plain(pred, tgt), rtol=0, atol=0)
    torch.testing.assert_close(dpred, plane_norms_bwd_plain(pred, tgt, 2 * g[:, 0]),
                               rtol=0, atol=0)
    assert dtgt is None


def test_output_layout_nhwc_is_the_same_values_channels_last():
    cfg = {"name": "filmavit", "params": TINY["params"]}
    model = build_model(cfg, DATA_CFG).eval()
    assert model.supports_output_layout
    x, _, cond = (torch.from_numpy(a) for a in synthetic_batch(2, 2, 4, 16, 16,
                                                                 num_fluid_params=9))
    with torch.no_grad():
        nchw = model(x, cond)
        nhwc = model(x, cond, output_layout="nhwc")
    assert nhwc.shape == (2, 2, 16, 16, 4)
    torch.testing.assert_close(nhwc, nchw.permute(0, 1, 3, 4, 2), rtol=0, atol=0)
    with pytest.raises(ValueError, match="nchw|nhwc"):
        model(x, cond, output_layout="hwc")


def _step_grads(cls, model_cfg, batch, layout):
    module = cls(model_cfg, DATA_CFG, ADAMW, SCHED, total_steps=4, device="cpu",
                 loss_layout=layout)
    assert module.loss_layout == layout and module._use_nhwc_loss() == (layout == "nhwc")
    with torch.no_grad():  # LayerScale and feature scales at O(1): every block contributes
        for name, p in module.model.named_parameters():
            if "gamma" in name or "freq" in name:
                p.fill_(0.5)
    m = module.train_step(tuple(torch.from_numpy(a) for a in batch), None)
    return float(m["loss"]), {n: p.grad.clone() for n, p in module.model.named_parameters()}


@pytest.mark.parametrize("conditioned", [False, True])
def test_nhwc_loss_layout_matches_nchw(conditioned):
    """One train step from the same seeded weights: the same loss and every
    parameter's gradient."""
    if conditioned:
        batch = synthetic_batch(2, 2, 4, 16, 16, num_fluid_params=9)
        cls, cfg = ConditionedForecastModule, TINY
    else:
        batch = synthetic_batch(2, 2, 4, 16, 16)
        params = {k: v for k, v in TINY["params"].items() if k != "num_fluid_params"}
        cls, cfg = ForecastModule, {"name": "avit", "params": params}
    loss_a, grads_a = _step_grads(cls, cfg, batch, "nchw")
    loss_b, grads_b = _step_grads(cls, cfg, batch, "nhwc")
    assert loss_b == pytest.approx(loss_a, rel=1e-6)
    # Gradients zero up to rounding (the k-LayerNorm biases, each MLP's
    # output bias, the low-frequency scales) against a hundredth of the
    # largest, as tests/test_torch_routes.py holds them.
    names = list(grads_a)
    top = max(float(g.abs().max()) for g in grads_a.values())
    zero = [n for n in names if float(grads_a[n].abs().max()) <= 1e-6 * top]
    assert all(n.endswith(("knorm.bias", "mlp.fc2.bias", "low_freq_scalar")) for n in zero), zero
    check_grads(["kn_bias" if n in zero else n for n in names], [grads_b[n] for n in names],
                [grads_a[n].numpy() for n in names], 1e-5)


def test_nhwc_loss_layout_steps_match_jax(monkeypatch):
    """Three AdamW steps with ``BUBBLEFORMER_LOSS_LAYOUT=nhwc``, which both
    modules read: the port's against the JAX module's."""
    monkeypatch.setenv("BUBBLEFORMER_LOSS_LAYOUT", "nhwc")
    port = _three_train_steps_match_jax(TINY, (16, 16))
    assert port.loss_layout == "nhwc" and port._use_nhwc_loss()


def test_loss_layout_is_validated_and_warns_without_a_channels_last_decode(monkeypatch):
    with pytest.raises(ValueError, match="nchw|nhwc"):
        ConditionedForecastModule(TINY, DATA_CFG, ADAMW, SCHED, total_steps=4, device="cpu",
                                  loss_layout="hwc")
    monkeypatch.setattr(FiLMAViT, "supports_output_layout", False)
    with pytest.warns(UserWarning, match="supports_output_layout"):
        module = ConditionedForecastModule(TINY, DATA_CFG, ADAMW, SCHED, total_steps=4,
                                           device="cpu", loss_layout="nhwc")
    assert not module._use_nhwc_loss()
    batch = synthetic_batch(2, 2, 4, 16, 16, num_fluid_params=9)
    assert np.isfinite(float(module.train_step(tuple(torch.from_numpy(a) for a in batch),
                                               None)["loss"]))


def test_loss_kernel_knob_leaves_cpu_predictions_on_the_criterion(monkeypatch):
    monkeypatch.setenv("BUBBLEFORMER_LOSS_KERNEL", "1")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        module = ConditionedForecastModule(TINY, DATA_CFG, ADAMW, SCHED, total_steps=4,
                                           device="cpu")
    pred, tgt = (torch.from_numpy(a) for a in _pred_tgt(21))
    before = plane_norms.launches
    assert float(module._loss(pred, tgt)) == float(module.criterion(pred, tgt))
    assert plane_norms.launches == before
