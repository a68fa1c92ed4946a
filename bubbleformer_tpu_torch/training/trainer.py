"""The training loop.

Counterpart of ``bubbleformer_tpu/training/trainer.py`` on one device:

* ``limit_train_batches`` / ``limit_val_batches`` budget each epoch;
* a CSV logger (``metrics.csv``) every ``log_every`` steps;
* SIGTERM only sets a flag; the next step boundary saves the numbered
  preemption checkpoint and returns;
* a non-finite logged loss saves ``non_finite_state.pt`` and raises;
* host-to-device copies from pinned memory run one batch ahead of the step;
* drop-path masks come from a generator seeded from ``(seed, step)``, so a
  resumed run draws the masks an uninterrupted one would have drawn.

The JAX trainer's device mesh, W&B logging, validation image panels and
profiler window are not ported.
"""
from __future__ import annotations

import csv
import os
import signal
import time
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from bubbleformer_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
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
    ):
        self.module = module
        self.device = module.device
        self.log_dir = log_dir
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.seed = seed
        self.log_every = log_every
        self.logger = CSVLogger(log_dir)
        self.preempt_ckpt_path = preempt_ckpt_path or os.path.join(log_dir, "hpc_ckpt_1.pt")
        self._preempted = False
        self._generator = torch.Generator(device=self.device)
        self.last_epoch_seconds = None  # the last epoch's training time, synchronised
        signal.signal(signal.SIGTERM, self._handle_preemption)

    def _handle_preemption(self, signum, frame):
        # Only flag here: the step boundary saves a consistent post-update state.
        self._preempted = True

    def _put_batch(self, batch) -> Tuple[torch.Tensor, ...]:
        """Host arrays -> tensors on the device; CUDA copies go through pinned
        memory without blocking, so they overlap the step before them."""
        parts = []
        for part in batch:
            t = torch.as_tensor(np.asarray(part))
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
        save_checkpoint(path, self.module)

    def fit(self, train_loader, val_loader=None, max_epochs: int = 1,
            ckpt_path: Optional[str] = None) -> ForecastModule:
        module = self.module
        if ckpt_path:
            self.restore(ckpt_path)
        print(parameter_table(module.model))
        global_step = module.step
        start_epoch = global_step // max(min(self.limit_train_batches, len(train_loader)), 1)

        for epoch in range(start_epoch, max_epochs):
            train_loader.set_epoch(epoch)
            epoch_start = time.time()
            n_batches = batch_size = 0
            for i, batch in enumerate(self._device_prefetch(train_loader,
                                                            self.limit_train_batches)):
                metrics = module.train_step(batch, self._step_generator(global_step))
                n_batches += 1
                batch_size = batch[0].shape[0]
                global_step += 1

                if self._preempted:
                    self.save(self.preempt_ckpt_path)
                    print(f"Preemption checkpoint saved to {self.preempt_ckpt_path}")
                    return module

                if i % self.log_every == 0:
                    loss = float(metrics["loss"])
                    if not np.isfinite(loss):
                        crash_path = os.path.join(self.log_dir, "non_finite_state.pt")
                        self.save(crash_path)
                        raise FloatingPointError(
                            f"non-finite loss {loss} at step {global_step}; "
                            f"state saved to {crash_path}")
                    self.logger.log({"step": global_step, "epoch": epoch, "split": "train",
                                     "loss": loss, "learning_rate": metrics["learning_rate"]})

            if n_batches:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                train_time = self.last_epoch_seconds = time.time() - epoch_start
                print(f"epoch {epoch}: {n_batches} steps in {train_time:.1f}s "
                      f"({n_batches * batch_size / train_time:.1f} samples/s incl. input pipeline)")

            if val_loader is not None:
                losses = [float(module.eval_step(batch)[0]["loss"]) for batch in
                          self._device_prefetch(val_loader, self.limit_val_batches)]
                if losses:
                    self.logger.log({"step": global_step, "epoch": epoch, "split": "val",
                                     "loss": float(np.mean(losses)),
                                     "learning_rate": float("nan")})

            self.save(os.path.join(self.log_dir, "last.pt"))
        return module
