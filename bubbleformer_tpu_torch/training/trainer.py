"""The training loop.

Counterpart of ``bubbleformer_tpu/training/trainer.py``:

* ``limit_train_batches`` / ``limit_val_batches`` budget each epoch;
* a CSV logger (``metrics.csv``) every ``log_every`` steps;
* SIGTERM only sets a flag; the next step boundary saves the numbered
  preemption checkpoint and returns;
* a non-finite logged loss saves ``non_finite_state.pt`` and raises;
* host-to-device copies from pinned memory run one batch ahead of the step;
* drop-path masks come from a generator seeded from ``(seed, step)``, so a
  resumed run draws the masks an uninterrupted one would have drawn;
* ``use_wandb``: W&B logging of the train and validation metrics, where the
  JAX trainer logs them (``:110-132``); ``wandb`` is an optional import, and
  a W&B that fails prints one line and leaves the CSV logging alone;
* ``plot_val_samples``: each epoch's SDF, temperature and velocity panels of
  the first validation sample, target against prediction, into
  ``val_epoch_{e}/`` (and to W&B when it is on; ``:245-275``);
* ``profile_dir``: a ``torch.profiler`` trace (CPU, and CUDA on the card)
  from global step ``profile_steps[0]`` up to ``profile_steps[1]``, each
  step a ``train_step {n}`` range, written once the device has synchronised
  (the JAX trainer's ``jax.profiler`` window, ``:325-332``);
* ``transfer_dtype``: float32 host arrays cross to the device in that dtype
  (``:156``) and stay in it, as in JAX: the model's layers compute in their
  ``dtype`` or else the input's, and the loss sees the targets rounded.

In a world of processes (the module's ``mesh``, ``parallel/mesh.py``) each
data rank steps on its own batch and the module's DDP averages the
gradients (under ``mesh_cfg=dp_tp`` the model ranks of a data rank share
its batch, and the samples counted are the data ranks').
The CSV, W&B, the validation panels, the parameter table, the profiler
window and the prints are the leader's (``:79,110,147,252,306``); the
logged training and validation losses are the means over the ranks; the
SIGTERM flag and a non-finite loss are agreed by all ranks at the step
boundary (one flag all-reduced over gloo), so that no rank leaves while the
others wait in the next all-reduce; a checkpoint is the leader's to write,
with every rank at a barrier before and after.  The drop-path generator is
seeded alike on every rank, and the model takes its rows of the global
batch's masks.
"""
from __future__ import annotations

import contextlib
import csv
import os
import signal
import time
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from bubbleformer_tpu_torch.parallel import host_any, host_barrier, host_mean, is_leader
from bubbleformer_tpu_torch.training.checkpoint import (
    checkpoint_state,
    restore_checkpoint,
    save_checkpoint,
)
from bubbleformer_tpu_torch.training.module import ForecastModule
from bubbleformer_tpu_torch.utils.summary import parameter_table


class CSVLogger:
    """Append-only metrics CSV."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.csv")
        self._header_written = os.path.exists(self.path)

    def log(self, row: Dict[str, Any]) -> None:
        with open(self.path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(row.keys()))
            if not self._header_written:
                writer.writeheader()
                self._header_written = True
            writer.writerow(row)


class Trainer:
    """Train/val loop with checkpointing and preemption."""

    def __init__(
        self,
        module: ForecastModule,
        log_dir: str = "logs",
        limit_train_batches: int = 1000,
        limit_val_batches: int = 25,
        seed: int = 42,
        preempt_ckpt_path: Optional[str] = None,
        log_every: int = 10,
        use_wandb: bool = False,
        plot_val_samples: bool = False,
        profile_dir: Optional[str] = None,
        profile_steps: Tuple[int, int] = (10, 15),
        transfer_dtype: Optional[str] = None,
    ):
        self.module = module
        self.device = module.device
        self.log_dir = log_dir
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.seed = seed
        self.log_every = log_every
        self.leader = is_leader()
        self.logger = CSVLogger(log_dir) if self.leader else None
        self.preempt_ckpt_path = preempt_ckpt_path or os.path.join(log_dir, "hpc_ckpt_1.pt")
        self._preempted = False
        self._generator = torch.Generator(device=self.device)
        self.last_epoch_seconds = None  # the last epoch's training time, synchronised
        self.plot_val_samples = plot_val_samples
        self.profile_dir = profile_dir
        self.profile_steps = tuple(profile_steps)
        self.transfer_dtype = None if transfer_dtype is None else getattr(torch, transfer_dtype)
        self.wandb = _init_wandb(log_dir) if use_wandb and self.leader else None
        signal.signal(signal.SIGTERM, self._handle_preemption)

    def _handle_preemption(self, signum, frame):
        # Only flag here: the step boundary saves a consistent post-update state.
        self._preempted = True

    def _put_batch(self, batch) -> Tuple[torch.Tensor, ...]:
        """Host arrays -> tensors on the device; CUDA copies go through pinned
        memory without blocking, so they overlap the step before them.  Under
        ``transfer_dtype`` float32 arrays are cast to it before the copy."""
        parts = []
        for part in batch:
            t = torch.as_tensor(np.asarray(part))
            if self.transfer_dtype is not None and t.dtype == torch.float32:
                t = t.to(self.transfer_dtype)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            parts.append(t.to(self.device))
        return tuple(parts)

    def _device_prefetch(self, iterable: Iterable, limit: int):
        """Yield device batches with the copy of batch i+1 queued before
        batch i is consumed."""
        pending = None
        for i, batch in enumerate(iterable):
            if i >= limit:
                break
            current = self._put_batch(batch)
            if pending is not None:
                yield pending
            pending = current
        if pending is not None:
            yield pending

    def _step_generator(self, step: int) -> torch.Generator:
        return self._generator.manual_seed((self.seed + 1) * 1_000_003 + step)

    def restore(self, ckpt_path: str) -> None:
        restore_checkpoint(ckpt_path, self.module)

    def save(self, path: str) -> None:
        """The leader writes the checkpoint, whole (under tensor parallelism
        every rank takes part in gathering it); every rank waits for the
        others before and after, so that none reads or resumes a half-made
        one."""
        host_barrier()
        sharded = self.module.model_shard is not None
        state = checkpoint_state(self.module) if self.leader or sharded else None
        if self.leader:
            save_checkpoint(path, self.module, state)
        host_barrier()

    def _start_profile(self):
        """Start the ``torch.profiler`` window: CPU activity, and CUDA on the
        card."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> str:
        """Stop the window once the device has synchronised; the Chrome trace
        goes to ``profile_dir``.  Returns its path."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        first, last = self.profile_steps
        path = os.path.join(self.profile_dir, f"train_steps_{first}-{last}.pt.trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace of steps [{first}, {last}) written to {path}")
        return path

    def _log_val_images(self, val_sample, epoch: int) -> None:
        """Each epoch's validation panels (reference ``modules.py:197-253``):
        SDF, temperature and velocity of the first validation sample, target
        against prediction, to ``val_epoch_{epoch}/`` and to W&B when it is
        on."""
        if not (self.plot_val_samples and self.leader):
            return
        import matplotlib.pyplot as plt

        from bubbleformer_tpu_torch.utils import plot_utils

        batch, pred = val_sample
        fields = self.module.data_cfg["output_fields"]
        target = self.module.target(batch)[0].float().cpu().numpy()  # (T, C, H, W)
        pred = pred[0].float().cpu().numpy()
        out_dir = os.path.join(self.log_dir, f"val_epoch_{epoch}")
        os.makedirs(out_dir, exist_ok=True)
        figs = {}
        if "dfun" in fields:
            c = fields.index("dfun")
            figs["target_sdf"] = plot_utils.sdf_panel(target[:, c])
            figs["pred_sdf"] = plot_utils.sdf_panel(pred[:, c])
        if "temperature" in fields:
            c = fields.index("temperature")
            figs["target_temp"] = plot_utils.temp_panel(target[:, c])
            figs["pred_temp"] = plot_utils.temp_panel(pred[:, c])
        if "velx" in fields and "vely" in fields:
            cx, cy = fields.index("velx"), fields.index("vely")
            figs["target_vel"] = plot_utils.vel_panel(target[:, [cx, cy]])
            figs["pred_vel"] = plot_utils.vel_panel(pred[:, [cx, cy]])
        for name, fig in figs.items():
            fig.savefig(os.path.join(out_dir, f"{name}.png"), bbox_inches="tight")
            if self.wandb is not None:
                self.wandb.log({name: self.wandb.Image(fig, caption=f"Epc {epoch}")})
            plt.close(fig)

    def fit(self, train_loader, val_loader=None, max_epochs: int = 1,
            ckpt_path: Optional[str] = None) -> ForecastModule:
        module = self.module
        if ckpt_path:
            self.restore(ckpt_path)
        if self.leader:
            print(parameter_table(module.model))
            if module.mesh.model > 1:
                print(f"(model rank 0's slices of {module.mesh.model}: the column- and "
                      "row-parallel layers hold a share of their features)")
        global_step = module.step
        prof = None
        start_epoch = global_step // max(min(self.limit_train_batches, len(train_loader)), 1)

        for epoch in range(start_epoch, max_epochs):
            train_loader.set_epoch(epoch)
            epoch_start = time.time()
            n_batches = batch_size = 0
            for i, batch in enumerate(self._device_prefetch(train_loader,
                                                            self.limit_train_batches)):
                if self.profile_dir and self.leader and global_step == self.profile_steps[0]:
                    prof = self._start_profile()
                with (contextlib.nullcontext() if prof is None
                      else torch.profiler.record_function(f"train_step {global_step}")):
                    metrics = module.train_step(batch, self._step_generator(global_step))
                n_batches += 1
                batch_size = batch[0].shape[0]
                global_step += 1
                if prof is not None and global_step == self.profile_steps[1]:
                    self._stop_profile(prof)
                    prof = None

                if host_any(self._preempted):  # any rank's SIGTERM stops all
                    self.save(self.preempt_ckpt_path)
                    if self.leader:
                        print(f"Preemption checkpoint saved to {self.preempt_ckpt_path}")
                    return module

                if i % self.log_every == 0:
                    loss = host_mean(float(metrics["loss"]))
                    if not np.isfinite(loss):
                        crash_path = os.path.join(self.log_dir, "non_finite_state.pt")
                        self.save(crash_path)
                        raise FloatingPointError(
                            f"non-finite loss {loss} at step {global_step}; "
                            f"state saved to {crash_path}")
                    lr = metrics["learning_rate"]
                    if self.logger is not None:
                        self.logger.log({"step": global_step, "epoch": epoch,
                                         "split": "train", "loss": loss, "learning_rate": lr})
                    if self.wandb is not None:
                        self.wandb.log({"train_loss": loss, "learning_rate": lr})

            if n_batches and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            train_time = time.time() - epoch_start
            if n_batches:
                self.last_epoch_seconds = train_time
                world, model = self.module.mesh.data, self.module.mesh.model
                over = (f"{world} process{'es' if world > 1 else ''}" if model == 1 else
                        f"{world} data rank{'s' if world > 1 else ''} of {world * model} "
                        "processes")
                if self.leader:
                    print(f"epoch {epoch}: {n_batches} steps in {train_time:.1f}s "
                          f"({n_batches * batch_size * world / train_time:.1f} samples/s over "
                          f"{over} incl. input pipeline)")
            if self.wandb is not None:
                self.wandb.log({"train_epoch_time": train_time, "epoch": epoch})

            if val_loader is not None:
                val_start = time.time()
                losses, val_sample = [], None
                for batch in self._device_prefetch(val_loader, self.limit_val_batches):
                    metrics, pred = module.eval_step(batch)
                    losses.append(float(metrics["loss"]))
                    if val_sample is None:
                        val_sample = (batch, pred)
                if val_sample is not None:
                    self._log_val_images(val_sample, epoch)
                if losses:
                    val_loss = host_mean(float(np.mean(losses)))
                    if self.logger is not None:
                        self.logger.log({"step": global_step, "epoch": epoch, "split": "val",
                                         "loss": val_loss, "learning_rate": float("nan")})
                    if self.wandb is not None:
                        self.wandb.log({"val_loss": val_loss,
                                        "val_epoch_time": time.time() - val_start,
                                        "epoch": epoch})
                del val_sample

            self.save(os.path.join(self.log_dir, "last.pt"))
        if prof is not None:  # the run ended inside the window
            self._stop_profile(prof)
        return module


def _init_wandb(log_dir: str):
    """The ``wandb`` module after ``wandb.init``, or None where it cannot
    start: W&B is logging, and must never stop a run.  The API key is read
    from ``config/wandb_api_key.txt`` under the package where that file
    exists; ``resume="auto"`` as the reference's ``train.py:178-196``."""
    try:
        import wandb  # optional dependency

        key_path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "config", "wandb_api_key.txt")
        if os.path.exists(key_path):
            with open(key_path, "r", encoding="utf-8") as f:
                wandb.login(key=f.read().strip())
        wandb.init(project="bubbleformer_tpu", name=os.path.basename(os.path.abspath(log_dir)),
                   dir=log_dir, resume="auto")
        return wandb
    except Exception as e:  # noqa: BLE001 - a failing W&B leaves the CSV logging alone
        print(f"wandb unavailable ({e}); continuing with CSV logging only")
        return None
