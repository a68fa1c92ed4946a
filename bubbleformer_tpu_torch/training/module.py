"""Forecast training modules: model + criterion + optimizer + schedule.

Counterparts of ``bubbleformer_tpu/training/module.py``'s
``ForecastModule`` and ``ConditionedForecastModule``.  The data config
injects the field counts and the time window into the model config
(``:63-70``), and the criterion is ``LpLoss(d=2, p=2, reduce_dims=[0, 1, 2],
reductions=["mean", "mean", "sum"])`` (``:72-74``) on the ``(B, T, C, H, W)``
output.  Where the JAX module builds pure step functions over a state
pytree, this one holds the model (on ``device``), the optimizer and the step
count, and :meth:`ForecastModule.train_step` updates them in place.

The learning rate of the update made at step ``t`` (counting from 0) is
``schedule(t)``, as optax applies its schedule, so ``cosine_warmup``'s
first update has lr 0.  The channels-last loss (``loss_layout="nhwc"``) and
the Pallas loss kernel (K10, ``BUBBLEFORMER_LOSS_KERNEL``) are not ported:
only the ``nchw`` criterion exists here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from bubbleformer_tpu_torch.models import build_model
from bubbleformer_tpu_torch.training.optim import make_optimizer
from bubbleformer_tpu_torch.utils.losses import LpLoss
from bubbleformer_tpu_torch.utils.schedulers import make_schedule


def resolve_device(device: str) -> torch.device:
    """``torch.device(device)``; a CUDA device without a card raises, so no
    run falls back to the CPU unless the caller asked for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was asked for but torch.cuda.is_available() is false; "
            "ask for the CPU explicitly (device=cpu) to run without a card"
        )
    return dev


class ForecastModule:
    """Unconditioned forecasting: batch = (inp, tgt)."""

    conditioned = False

    def __init__(
        self,
        model_cfg: Dict[str, Any],
        data_cfg: Dict[str, Any],
        optim_cfg: Dict[str, Any],
        scheduler_cfg: Dict[str, Any],
        total_steps: int,
        normalization_constants: Optional[Tuple[Dict, Dict]] = None,
        compute_dtype: Optional[str] = None,
        device: str = "cuda",
        seed: int = 42,
    ):
        self.model_cfg = dict(model_cfg)
        self.data_cfg = dict(data_cfg)
        self.optim_cfg = dict(optim_cfg)
        self.scheduler_cfg = dict(scheduler_cfg)
        self.total_steps = total_steps
        self.normalization_constants = normalization_constants
        self.device = resolve_device(device)

        # Parameters are drawn from ``seed`` without touching the global RNG.
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = build_model(self.model_cfg, self.data_cfg, compute_dtype)
        self.model = model.to(self.device)
        self.criterion = LpLoss(d=2, p=2, reduce_dims=[0, 1, 2],
                                reductions=["mean", "mean", "sum"])

        opt_params = dict(self.optim_cfg.get("params", {}))
        opt_params.pop("use_triton", None)  # the reference's GPU knob; nothing to select here
        base_lr = opt_params.pop("lr")
        self.schedule = make_schedule(self.scheduler_cfg["name"], base_lr, total_steps,
                                      **self.scheduler_cfg.get("params", {}))
        self.optimizer = make_optimizer(self.optim_cfg["name"], self.model.parameters(),
                                        **opt_params)
        self.step = 0

    def inputs(self, batch: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        return (batch[0],)

    def target(self, batch: Sequence[torch.Tensor]) -> torch.Tensor:
        return batch[1]

    def train_step(self, batch: Sequence[torch.Tensor],
                   generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """One update on ``batch`` (tensors on the module's device); the
        drop-path masks come from ``generator``.  Returns the loss (a 0-d
        tensor, not synchronised) and the learning rate used."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        pred = self.model(*self.inputs(batch), generator=generator)
        loss = self.criterion(pred, self.target(batch))
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return {"loss": loss.detach(), "learning_rate": lr}

    @torch.no_grad()
    def eval_step(self, batch: Sequence[torch.Tensor]):
        """``({"loss": loss}, prediction)`` in eval mode."""
        self.model.eval()
        pred = self.model(*self.inputs(batch))
        return {"loss": self.criterion(pred, self.target(batch))}, pred


class ConditionedForecastModule(ForecastModule):
    """FiLM-conditioned forecasting: batch = (inp, tgt, fluid_params)."""

    conditioned = True

    def inputs(self, batch: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        return (batch[0], batch[2])
