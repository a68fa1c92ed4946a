#!/usr/bin/env python3
"""Sustained end-to-end training throughput of the PyTorch port from files.

Counterpart of ``scripts/probe_e2e_train.py``: ``Trainer.fit`` with the real
input pipeline attached — ``.npy`` field caches of BubbleML-shaped
trajectories (``scripts/make_sample_data_torch.py --format npy``) ->
``BubbleForecast`` -> the native C/OpenMP batch assembler -> ``DataLoader``
-> the trainer's pinned, one-ahead host-to-device copies -> the bf16 step —
against the same ``Trainer.fit`` on synthetic batches, and the gap between
them split into its parts, each measured alone on the same batches:

* the device-only step (``module.train_step`` on a batch already on the
  card, CUDA-synchronised);
* the host assembly rate (the loader alone, native and numpy paths);
* the host-to-device copy of one batch as the trainer makes it
  (``training/trainer.py:_put_batch``): each part's ``pin_memory()`` (a host
  copy, on the step's thread) and its copy to the card, each synchronised
  (medians of 5 after one).

Defaults: FiLMAViT-small on its default route (K1 temporal, K2 axial), bf16,
remat ``"dots"``, Lion, batch 8 of 5-frame windows at 512x512 with the
fluid parameters, ``--steps`` steps a fit.  Each fit's time is the trainer's
epoch time (the first batch's wait included) over its steps.  Prints one
JSON line, also written to ``--out``.

    python scripts/probe_e2e_train_torch.py
    python scripts/probe_e2e_train_torch.py --device cpu --model-cfg film_avit_tiny \\
        --size 32 --frames 30 --batch 2 --steps 2
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

FIELDS = ["dfun", "temperature", "velx", "vely"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-cfg", default="film_avit_small")
    ap.add_argument("--optim-cfg", default="lion")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--transfer-dtype", default=None, choices=[None, "bfloat16"])
    ap.add_argument("--device", default="cuda",
                    help="torch device; without a CUDA card, pass --device cpu")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "e2e_train_torch.json"))
    args = ap.parse_args(argv)

    from bubbleformer_tpu_torch.config import load_config
    from bubbleformer_tpu_torch.data import (
        BubbleForecast,
        DataLoader,
        SyntheticLoader,
        native,
    )
    from bubbleformer_tpu_torch.training import Trainer, module_class, resolve_device
    from scripts.make_sample_data_torch import main as make_samples

    device = resolve_device(args.device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    workdir = args.workdir or tempfile.mkdtemp(prefix="e2e_train_")
    samples = os.path.join(workdir, "samples")
    t0 = time.perf_counter()
    make_samples(["--out", samples, "--n", "2", "--frames", str(args.frames),
                  "--size", str(args.size), "--format", "npy"])
    write_s = time.perf_counter() - t0

    cfg = load_config([f"model_cfg={args.model_cfg}", f"optim_cfg={args.optim_cfg}",
                       "scheduler_cfg.params.warmup_iters=2"])
    model_cfg = cfg["model_cfg"]
    data_cfg = dict(cfg["data_cfg"], input_fields=FIELDS, output_fields=FIELDS,
                    time_window=5, start_time=5, return_fluid_params=True)
    module_cls = module_class(model_cfg, data_cfg)
    # The same files on each path; the first path's loader feeds the
    # device-only and copy measurements.
    loaders = {}
    for path in ("native", "numpy"):
        dataset = BubbleForecast(
            [os.path.join(samples, f"sample_{i + 1}.hdf5") for i in range(2)],
            input_fields=FIELDS, output_fields=FIELDS, norm="std", time_window=5,
            start_time=5, return_fluid_params=module_cls.conditioned)
        dataset.normalize()
        if path == "native" and not dataset.enable_native():
            print(f"native loader unavailable: {native.unavailable_reason()}", flush=True)
            continue
        loaders[path] = DataLoader(dataset, args.batch, shuffle=True, seed=cfg["seed"],
                                   num_workers=args.workers)
    native_ok = "native" in loaders
    loader = next(iter(loaders.values()))
    if len(loader) < args.steps + 1:
        raise SystemExit(f"{len(loader)} batches an epoch; --steps {args.steps} needs "
                         f"{args.steps + 1}: raise --frames")

    module = module_cls(model_cfg=model_cfg, data_cfg=data_cfg, optim_cfg=cfg["optim_cfg"],
                        scheduler_cfg=cfg["scheduler_cfg"], total_steps=10_000,
                        normalization_constants=(loader.dataset.diff_terms,
                                                 loader.dataset.div_terms),
                        compute_dtype="bfloat16", device=str(device), seed=cfg["seed"])
    trainer = Trainer(module, log_dir=os.path.join(workdir, "logs"),
                      limit_train_batches=args.steps, seed=cfg["seed"],
                      transfer_dtype=args.transfer_dtype)

    # 1. Host assembly rate, each path (no device involved).
    first = next(iter(loader))
    batch_bytes = sum(p.nbytes for p in first)
    assembly = {}
    for path, path_loader in loaders.items():
        it = iter(path_loader)
        next(it)
        t0 = time.perf_counter()
        n = min(8, len(path_loader) - 1)
        for _ in range(n):
            next(it)
        assembly[path] = (time.perf_counter() - t0) / n * 1e3
        it.close()

    # 2. The host-to-device copy of one batch, as _put_batch makes it.
    def put_parts(batch):
        pin = copy = 0.0
        for part in batch:
            t = torch.as_tensor(np.asarray(part))
            if trainer.transfer_dtype is not None and t.dtype == torch.float32:
                t = t.to(trainer.transfer_dtype)
            t0 = time.perf_counter()
            if cuda:
                t = t.pin_memory()
            t1 = time.perf_counter()
            t.to(device, non_blocking=True)
            sync()
            pin, copy = pin + t1 - t0, copy + time.perf_counter() - t1
        return pin * 1e3, copy * 1e3

    put_parts(first)
    pins, copies = zip(*(put_parts(first) for _ in range(5)))
    pin_ms, copy_ms = float(np.median(pins)), float(np.median(copies))
    resident = trainer._put_batch(first)

    # 3. The device-only step on a resident batch (after one warm-up step).
    gen = torch.Generator(device=device)
    module.train_step(resident, gen.manual_seed(0))
    sync()
    t0 = time.perf_counter()
    for i in range(args.steps):
        metrics = module.train_step(resident, gen.manual_seed(i + 1))
    float(metrics["loss"])
    sync()
    device_ms = (time.perf_counter() - t0) / args.steps * 1e3

    # 4. Trainer.fit on synthetic batches, then on the files (each a fresh
    # epoch of --steps steps).
    def fit(train_loader) -> float:
        epoch = module.step // min(args.steps, len(train_loader))
        trainer.fit(train_loader, max_epochs=epoch + 1)
        return trainer.last_epoch_seconds / args.steps * 1e3

    fluid = first[2].shape[1] if module_cls.conditioned else None
    synthetic_ms = fit(SyntheticLoader(args.steps, args.batch, 5, len(FIELDS), args.size,
                                       fluid, seed=cfg["seed"]))
    files_ms = {path: fit(path_loader) for path, path_loader in loaders.items()}

    e2e_ms = files_ms["native" if native_ok else "numpy"]
    result = {
        "config": f"{args.model_cfg}_{args.size}px_b{args.batch}_tw5_bf16_dots",
        "steps": args.steps,
        "native_loader": native_ok,
        "batch_mb": batch_bytes / 1e6,
        "samples_write_s": write_s,
        "host_assembly_ms_per_batch": assembly,
        "pin_memory_ms_per_batch": pin_ms,
        "copy_ms_per_batch": copy_ms,
        "copy_gb_per_s": batch_bytes / copy_ms / 1e6,
        "device_only_step_ms": device_ms,
        "synthetic_fit_step_ms": synthetic_ms,
        "files_fit_step_ms": files_ms,
        "device_only_samples_per_s": args.batch / device_ms * 1e3,
        "synthetic_samples_per_s": args.batch / synthetic_ms * 1e3,
        "files_samples_per_s": {k: args.batch / v * 1e3 for k, v in files_ms.items()},
        "gap_to_synthetic_ms": e2e_ms - synthetic_ms,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "cpus": os.cpu_count(),
    }
    print(json.dumps(result))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
