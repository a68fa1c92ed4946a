#!/usr/bin/env python3
"""Training entry point of the PyTorch port.

Counterpart of ``scripts/train.py`` on ``bubbleformer_tpu_torch``: the same
``key=value`` overrides composed over the port's own config tree, the
process group joined first (``parallel/mesh.py:initialize_distributed``)
and the mesh built from ``mesh_cfg`` (``single``: data parallelism over
every process; ``dp_tp``, ``dp_sp`` and ``mesh_cfg.model>1`` raise, tensor
and spatial parallelism not being ported), the sliding-window datasets
(each file from its ``.hdf5``, or from its ``.npy`` field caches where
h5py or the file is missing) with train
normalization constants applied to validation, ``native_loader`` (default
true: the C/OpenMP batch assembler over memory-mapped caches, as
``scripts/train.py:87-92``; it prints ``native loader: enabled``, or
``unavailable`` with the reason and the numpy path), the
(conditioned) forecast module and the trainer with preemption checkpoints.
The module follows the model: a data config that returns fluid parameters
to a model without FiLM trains the unconditioned module, which ignores them.
``use_wandb``, ``plot_val_samples`` (null: follow ``use_wandb``),
``profile_dir`` (a ``torch.profiler`` trace of steps 10-15) and
``transfer_dtype`` reach the trainer as in ``scripts/train.py:146-164``.

Data parallelism: one process a GPU, launched by ``torchrun`` or ``srun``;
each process prints one world line, reads its strided shard of each epoch
(``batch_size`` is per process: the global batch is ``batch_size`` times
the processes), and the leader alone writes ``metrics.csv`` and the
checkpoints.  NCCL on the cards; ``device=cpu`` runs the world on gloo.

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        scripts/train_torch.py data_cfg=poolboiling_saturated batch_size=2
    srun --ntasks-per-node 4 --gpus-per-node 4 python scripts/train_torch.py ...

Overrides the JAX script does not have:

* ``device=`` (default ``cuda``: the card ``LOCAL_RANK`` in a world of
  processes): the torch device.  Without a CUDA card the run raises unless
  ``device=cpu`` asks for the CPU.
* ``synthetic_batches=N``: train on N random batches of 512x512 windows
  made from ``seed`` instead of the data config's files (no validation),
  where no data are at hand.

    python scripts/train_torch.py data_cfg=poolboiling_saturated max_epochs=400
    python scripts/make_sample_data_torch.py --out samples --format npy --size 512 --frames 40
    BUBBLEML_SAMPLES=samples python scripts/train_torch.py data_cfg=samples_smoke \
        data_cfg.return_fluid_params=true limit_train_batches=6
    python scripts/train_torch.py model_cfg=avit_big optim_cfg=adamw batch_size=8 \\
        synthetic_batches=6 limit_train_batches=6 scheduler_cfg.params.warmup_iters=2
    python scripts/train_torch.py synthetic_batches=6 limit_train_batches=6 \\
        scheduler_cfg.params.warmup_iters=2 log_dir=/tmp/logs
    python scripts/train_torch.py model_cfg.params.bias_type=continuous synthetic_batches=16 \\
        limit_train_batches=16 profile_dir=/tmp/trace transfer_dtype=bfloat16
    BUBBLEFORMER_LOSS_KERNEL=1 python scripts/train_torch.py model_cfg=unet_modern \\
        batch_size=8 synthetic_batches=6 limit_train_batches=6 \\
        scheduler_cfg.params.warmup_iters=2
"""
from __future__ import annotations

import os
import pprint
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from bubbleformer_tpu_torch.config import load_config
from bubbleformer_tpu_torch.data import BubbleForecast, DataLoader, SyntheticLoader, native
from bubbleformer_tpu_torch.parallel import initialize_distributed, is_leader, make_mesh
from bubbleformer_tpu_torch.training import (
    Trainer,
    module_class,
    next_preempt_ckpt_path,
    resolve_device,
)

SYNTHETIC_SIZE = 512  # the BubbleML windows' resolution


def main(argv=None) -> Trainer:
    cfg = load_config(argv if argv is not None else sys.argv[1:])
    device = str(cfg.get("device", "cuda"))
    initialize_distributed(device=device)
    mesh_cfg = cfg.get("mesh_cfg", {"data": -1, "model": 1})
    mesh = make_mesh(data=mesh_cfg.get("data", -1), model=mesh_cfg.get("model", 1),
                     spatial=mesh_cfg.get("spatial", 1), device=str(resolve_device(device)))
    shard = dict(process_index=mesh.rank, process_count=mesh.data)
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
            seed=cfg["seed"], **shard)
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
        if cfg.get("native_loader", True):
            # C/OpenMP batch assembly over memory-mapped field caches; where
            # the assembler does not build, the numpy path, and the reason.
            used_native = train_dataset.enable_native() and val_dataset.enable_native()
            if used_native and is_leader():
                print("native loader: enabled", flush=True)
            elif is_leader():
                print(f"native loader: unavailable ({native.unavailable_reason()}); "
                      "reading batches on the numpy path", flush=True)
        train_loader = DataLoader(train_dataset, cfg["batch_size"], shuffle=True,
                                  seed=cfg["seed"], num_workers=8, **shard)
        val_loader = DataLoader(val_dataset, cfg["batch_size"], num_workers=4, **shard)

    limit_train = cfg.get("limit_train_batches", 1000)
    total_steps = min(len(train_loader), limit_train) * cfg["max_epochs"]
    # One line a process (scripts/train.py:108-113's world report).
    print(f"process {mesh.rank}/{mesh.data}: {len(train_loader)} train batches/epoch, "
          f"local batch {cfg['batch_size']} (global {cfg['batch_size'] * mesh.data}), "
          f"device {mesh.device}, backend {mesh.backend or 'none'}", flush=True)

    module = module_cls(
        model_cfg=model_cfg, data_cfg=data_cfg, optim_cfg=cfg["optim_cfg"],
        scheduler_cfg=cfg["scheduler_cfg"], total_steps=total_steps,
        normalization_constants=normalization_constants,
        compute_dtype=cfg.get("compute_dtype"), seed=cfg["seed"],
        loss_layout=cfg.get("loss_layout"), mesh=mesh,
    )
    use_wandb = bool(cfg.get("use_wandb", False))
    trainer = Trainer(
        module, log_dir=log_dir, limit_train_batches=limit_train,
        limit_val_batches=cfg.get("limit_val_batches", 25), seed=cfg["seed"],
        preempt_ckpt_path=next_preempt_ckpt_path(log_dir, ckpt_path), use_wandb=use_wandb,
        # The reference logs the validation panels every epoch when W&B is on.
        plot_val_samples=(use_wandb if cfg.get("plot_val_samples") is None
                          else bool(cfg["plot_val_samples"])),
        profile_dir=cfg.get("profile_dir") or None,
        transfer_dtype=cfg.get("transfer_dtype") or None,
    )
    if is_leader():
        pprint.PrettyPrinter(depth=4).pprint(cfg)
    trainer.fit(train_loader, val_loader, max_epochs=cfg["max_epochs"], ckpt_path=ckpt_path)
    return trainer


if __name__ == "__main__":
    main()
