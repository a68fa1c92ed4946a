#!/usr/bin/env python3
"""Training entry point of the PyTorch port.

Counterpart of ``scripts/train.py`` on ``bubbleformer_tpu_torch``: the same
``key=value`` overrides composed over the port's own config tree (the
``mesh_cfg`` group is ignored: the port has no mesh), the sliding-window
datasets with train normalization constants applied to validation, the
(conditioned) forecast module and the trainer with preemption checkpoints.
The module follows the model: a data config that returns fluid parameters
to a model without FiLM trains the unconditioned module, which ignores them.

Overrides the JAX script does not have:

* ``device=`` (default ``cuda``): the torch device.  Without a CUDA card
  the run raises unless ``device=cpu`` asks for the CPU.
* ``synthetic_batches=N``: train on N random batches of 512x512 windows
  made from ``seed`` instead of the data config's HDF5 files (no
  validation), where no data are at hand.

    python scripts/train_torch.py data_cfg=poolboiling_saturated max_epochs=400
    python scripts/train_torch.py model_cfg=avit_big optim_cfg=adamw batch_size=8 \\
        synthetic_batches=6 limit_train_batches=6 scheduler_cfg.params.warmup_iters=2
    python scripts/train_torch.py synthetic_batches=6 limit_train_batches=6 \\
        scheduler_cfg.params.warmup_iters=2 log_dir=/tmp/logs
"""
from __future__ import annotations

import os
import pprint
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from bubbleformer_tpu_torch.config import load_config
from bubbleformer_tpu_torch.data import BubbleForecast, DataLoader, SyntheticLoader
from bubbleformer_tpu_torch.training import (
    Trainer,
    module_class,
    next_preempt_ckpt_path,
    resolve_device,
)

SYNTHETIC_SIZE = 512  # the BubbleML windows' resolution


def main(argv=None) -> None:
    cfg = load_config(argv if argv is not None else sys.argv[1:])
    device = resolve_device(str(cfg.get("device", "cuda")))
    np.random.seed(cfg["seed"])
    data_cfg, model_cfg = cfg["data_cfg"], cfg["model_cfg"]

    if cfg.get("checkpoint_path"):
        ckpt_path = cfg["checkpoint_path"]
        log_dir = os.path.dirname(ckpt_path)
    else:
        ckpt_path = None
        job_id = os.getenv("SLURM_JOB_ID") or os.getenv("JOB_ID") or "local"
        log_dir = os.path.join(
            cfg["log_dir"], f"{model_cfg['name'].lower()}_{data_cfg['dataset'].lower()}_{job_id}")
        os.makedirs(log_dir, exist_ok=True)

    synthetic = cfg.get("synthetic_batches")
    module_cls = module_class(model_cfg, data_cfg)
    with_fluid = data_cfg["return_fluid_params"]
    if synthetic:
        fluid = model_cfg["params"].get("num_fluid_params", 9) if with_fluid else None
        train_loader = SyntheticLoader(
            int(synthetic), cfg["batch_size"], data_cfg["time_window"],
            len(data_cfg["input_fields"]), SYNTHETIC_SIZE, fluid,
            seed=cfg["seed"])
        val_loader, normalization_constants = None, None
    else:
        common = dict(
            input_fields=data_cfg["input_fields"], output_fields=data_cfg["output_fields"],
            norm=data_cfg["normalize"], downsample_factor=data_cfg["downsample_factor"],
            time_window=data_cfg["time_window"], start_time=data_cfg["start_time"],
            return_fluid_params=with_fluid,
        )
        train_dataset = BubbleForecast(filenames=data_cfg["train_paths"], **common)
        normalization_constants = train_dataset.normalize()
        val_dataset = BubbleForecast(filenames=data_cfg["val_paths"], **common)
        val_dataset.normalize(*normalization_constants)
        train_loader = DataLoader(train_dataset, cfg["batch_size"], shuffle=True,
                                  seed=cfg["seed"], num_workers=8)
        val_loader = DataLoader(val_dataset, cfg["batch_size"], num_workers=4)

    limit_train = cfg.get("limit_train_batches", 1000)
    total_steps = min(len(train_loader), limit_train) * cfg["max_epochs"]
    print(f"{len(train_loader)} train batches/epoch, batch {cfg['batch_size']}, "
          f"device {device}", flush=True)

    module = module_cls(
        model_cfg=model_cfg, data_cfg=data_cfg, optim_cfg=cfg["optim_cfg"],
        scheduler_cfg=cfg["scheduler_cfg"], total_steps=total_steps,
        normalization_constants=normalization_constants,
        compute_dtype=cfg.get("compute_dtype"), device=str(device), seed=cfg["seed"],
        loss_layout=cfg.get("loss_layout"),
    )
    trainer = Trainer(
        module, log_dir=log_dir, limit_train_batches=limit_train,
        limit_val_batches=cfg.get("limit_val_batches", 25), seed=cfg["seed"],
        preempt_ckpt_path=next_preempt_ckpt_path(log_dir, ckpt_path),
    )
    pprint.PrettyPrinter(depth=4).pprint(cfg)
    trainer.fit(train_loader, val_loader, max_epochs=cfg["max_epochs"], ckpt_path=ckpt_path)


if __name__ == "__main__":
    main()
