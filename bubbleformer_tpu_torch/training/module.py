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
first update has lr 0.

Two knobs of the JAX module (``:76-104``, ``:117-153``, ``:204-230``):

* ``loss_layout`` (constructor, else ``BUBBLEFORMER_LOSS_LAYOUT``, else
  ``"nchw"``): ``"nhwc"`` has the train step ask the model for its
  channels-last output (``output_layout="nhwc"``) and compute the same
  criterion with its plane sums over axes (2, 3) against the target
  relayouted once outside the gradient (:meth:`ForecastModule._loss_nhwc`);
  a model without ``supports_output_layout`` warns and keeps ``"nchw"``.
  The eval step stays ``"nchw"``.
* ``BUBBLEFORMER_LOSS_KERNEL=1``: the ``nchw`` criterion of a 5-D
  prediction on the card runs through K10
  (:func:`~bubbleformer_tpu_torch.ops.lp_loss.training_lp_loss`), as the JAX
  module takes its Pallas kernel on a TPU; the same function, its plane sums
  in another order.

The U-Nets train through the unconditioned module: :meth:`ForecastModule.
train_step` runs the model in train mode (ClassicUnet's BatchNorms
normalise with the batch's statistics and update their running ones, as the
JAX step's ``mutable=["batch_stats"]``), :meth:`ForecastModule.eval_step` in
eval mode (the running statistics); their 5-D output takes K10 under
``BUBBLEFORMER_LOSS_KERNEL=1`` on the card, and ``loss_layout="nhwc"``
warns and keeps NCHW (they have no channels-last output).

:func:`module_class` picks the module by the model: a data config that
returns fluid parameters to a model without FiLM (``poolboiling_saturated``
with ``avit_big``, the README's pairing) gets the unconditioned module,
which reads ``(inp, tgt)`` and leaves the rest of the batch alone, as the
JAX ``ForecastModule`` does.

Data parallelism (``parallel/mesh.py``): the module takes the run's
``mesh`` (else :func:`~bubbleformer_tpu_torch.parallel.make_mesh` over the
world, on ``device``: the card ``LOCAL_RANK`` in a world of processes).
Where the world has more than one process, or where ``ddp=True`` asks for
it, :meth:`ForecastModule.train_step` runs the model wrapped in
``DistributedDataParallel`` (``find_unused_parameters=False``), whose
all-reduce averages the gradients over the ranks; ``self.model`` stays the
model itself, so ``state_dict``, :meth:`eval_step`, the rollout and the
bridges see no ``module.`` prefix.  Each rank's batch is its share of the
global batch, and the model learns where it sits in it
(``batch_shard``): the AViTs draw every drop-path mask for the global batch
and take their rows, and ClassicUnet's BatchNorms normalise with the global
batch's statistics, as the JAX package's global arrays have them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import os
import warnings

import torch

from bubbleformer_tpu_torch.models import build_model
from bubbleformer_tpu_torch.ops.lp_loss import training_lp_loss
from bubbleformer_tpu_torch.parallel import Mesh, make_mesh
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
        loss_layout: Optional[str] = None,
        mesh: Optional[Mesh] = None,
        ddp: Optional[bool] = None,
    ):
        self.model_cfg = dict(model_cfg)
        self.data_cfg = dict(data_cfg)
        self.optim_cfg = dict(optim_cfg)
        self.scheduler_cfg = dict(scheduler_cfg)
        self.total_steps = total_steps
        self.normalization_constants = normalization_constants
        self.mesh = mesh if mesh is not None else make_mesh(device=str(resolve_device(device)))
        self.device = resolve_device(str(self.mesh.device))

        # Parameters are drawn from ``seed`` without touching the global RNG,
        # the same on every rank.
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = build_model(self.model_cfg, self.data_cfg, compute_dtype)
        self.model = model.to(self.device)
        self.train_model = self.model
        if ddp or (ddp is None and self.mesh.data > 1):
            for m in self.model.modules():
                if hasattr(m, "batch_shard"):
                    m.batch_shard = (self.mesh.rank, self.mesh.data)
            self.train_model = torch.nn.parallel.DistributedDataParallel(
                self.model, device_ids=None if self.device.type == "cpu" else [self.device],
                find_unused_parameters=False)
        self.criterion = LpLoss(d=2, p=2, reduce_dims=[0, 1, 2],
                                reductions=["mean", "mean", "sum"])
        if loss_layout is None:
            loss_layout = os.environ.get("BUBBLEFORMER_LOSS_LAYOUT", "nchw")
        if loss_layout not in ("nchw", "nhwc"):
            raise ValueError(f"loss_layout must be nchw|nhwc, got {loss_layout!r}")
        self.loss_layout = loss_layout
        if loss_layout == "nhwc" and not getattr(self.model, "supports_output_layout", False):
            warnings.warn(
                f"loss_layout='nhwc' requested but model {self.model_cfg['name']!r} has no "
                "native channels-last output path (supports_output_layout); training uses "
                "the default NCHW loss."
            )

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

    def _loss(self, pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """The training criterion on ``(B, T, C, H, W)``: through K10 where
        ``BUBBLEFORMER_LOSS_KERNEL=1`` and the prediction is on the card,
        else ``LpLoss``."""
        if (pred.ndim == 5 and os.environ.get("BUBBLEFORMER_LOSS_KERNEL", "0") == "1"
                and pred.device.type == "cuda"):
            return training_lp_loss(pred, tgt)
        return self.criterion(pred, tgt)

    @staticmethod
    def _loss_nhwc(pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """The training criterion on channels-last ``(B, T, H, W, C)``: the
        relative-L2 plane sums over axes (2, 3), the same elements as
        ``LpLoss``'s flattened (H, W), in float32."""
        p, t = pred.float(), tgt.float()
        diff_norm = torch.sqrt(((p - t) ** 2).sum(dim=(2, 3)))
        ynorm = torch.sqrt((t * t).sum(dim=(2, 3)))
        return (diff_norm / ynorm).sum(dim=-1).mean()

    def _use_nhwc_loss(self) -> bool:
        return self.loss_layout == "nhwc" and getattr(self.model, "supports_output_layout",
                                                      False)

    def train_step(self, batch: Sequence[torch.Tensor],
                   generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """One update on ``batch`` (tensors on the module's device); the
        drop-path masks come from ``generator``.  Returns the loss (a 0-d
        tensor, not synchronised) and the learning rate used."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.train_model.train()
        self.optimizer.zero_grad(set_to_none=True)
        if self._use_nhwc_loss():
            pred = self.train_model(*self.inputs(batch), generator=generator,
                                    output_layout="nhwc")
            # The target's relayout is a constant of the step, outside the gradient.
            loss = self._loss_nhwc(pred, self.target(batch).permute(0, 1, 3, 4, 2))
        else:
            pred = self.train_model(*self.inputs(batch), generator=generator)
            loss = self._loss(pred, self.target(batch))
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return {"loss": loss.detach(), "learning_rate": lr}

    @torch.no_grad()
    def eval_step(self, batch: Sequence[torch.Tensor]):
        """``({"loss": loss}, prediction)`` in eval mode."""
        self.model.eval()
        pred = self.model(*self.inputs(batch))
        return {"loss": self._loss(pred, self.target(batch))}, pred


class ConditionedForecastModule(ForecastModule):
    """FiLM-conditioned forecasting: batch = (inp, tgt, fluid_params)."""

    conditioned = True

    def inputs(self, batch: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        return (batch[0], batch[2])


def module_class(model_cfg: Dict[str, Any], data_cfg: Dict[str, Any]):
    """The forecast module for a model and a data config: the conditioned
    one for a FiLM model (which needs the data's fluid parameters, else
    this raises), the unconditioned one for any other model."""
    if model_cfg["name"].lower() != "filmavit":
        return ForecastModule
    if not data_cfg["return_fluid_params"]:
        raise ValueError(f"model {model_cfg['name']!r} is conditioned on fluid parameters, "
                         f"but data config {data_cfg['dataset']!r} returns none")
    return ConditionedForecastModule
