#!/usr/bin/env python3
"""Autoregressive rollout analysis with physics evaluation, on the PyTorch port.

Counterpart of ``examples/autoregressive_rollout.py``: roll a trained model
forward hundreds of steps on the device (``--device``, default ``cuda``),
then compare model and simulation with the per-field relative L2, the
eikonal residual of the SDF over time (model and simulation) and the
vapor-fraction (mass conservation) curves.  ``--ckpt`` is a checkpoint of
``scripts/train_torch.py`` or a bare state dict of the model
(``scripts/inference_torch.py:restore_model``); ``--data`` a trajectory's
``.hdf5``, or its ``.npy`` field caches beside it.  The curves are plotted
where matplotlib imports; ``rollout_eval.npz`` is written either way.

    python examples/autoregressive_rollout_torch.py --ckpt logs/run/last.pt \
        --data Twall_91.hdf5 --model-cfg avit_small --steps 500 --out rollout_eval
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from bubbleformer_tpu_torch.config import load_config
from bubbleformer_tpu_torch.data import BubbleForecast
from bubbleformer_tpu_torch.inference import make_rollout_fn, rollout_targets
from bubbleformer_tpu_torch.training import module_class, resolve_device
from bubbleformer_tpu_torch.utils.metrics import (
    eikonal_residual_per_step,
    relative_l2_per_field,
    vapor_fraction,
)
from scripts.inference_torch import restore_model


def plot_curves(out: str, timesteps, curves: dict, ylabel: str, title: str, name: str) -> None:
    """One figure of ``curves`` (label -> values over ``timesteps``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 6))
    for label, values in curves.items():
        plt.plot(timesteps, values, label=label)
    plt.xlabel("timestep"), plt.ylabel(ylabel), plt.legend(), plt.grid(True)
    plt.title(title)
    plt.savefig(os.path.join(out, name)), plt.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--model-cfg", default="avit_small")
    ap.add_argument("--data-cfg", default="singlebubble")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--start-time", type=int, default=100)
    ap.add_argument("--out", default="rollout_eval")
    ap.add_argument("--device", default="cuda",
                    help="torch device; without a CUDA card, pass --device cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config([f"model_cfg={args.model_cfg}", f"data_cfg={args.data_cfg}"])
    data_cfg = dict(cfg["data_cfg"])
    conditioned = module_class(cfg["model_cfg"], data_cfg).conditioned
    dataset = BubbleForecast(
        [args.data], input_fields=data_cfg["input_fields"],
        output_fields=data_cfg["output_fields"], norm="none",
        downsample_factor=data_cfg["downsample_factor"], time_window=data_cfg["time_window"],
        start_time=args.start_time, return_fluid_params=conditioned)
    dataset.normalize()
    model = restore_model(args.ckpt, cfg["model_cfg"], data_cfg, dataset).to(device)
    num_windows = args.steps // dataset.time_window

    first = dataset[0]
    init = torch.from_numpy(first[0])[None].to(device)
    cond = torch.from_numpy(first[2])[None].to(device) if conditioned else None
    preds = make_rollout_fn(model, num_windows, conditioned=conditioned)(init, cond)
    preds = preds[:, 0].reshape(-1, *preds.shape[3:]).float().cpu()  # (T_total, C, H, W)
    targets, timesteps = rollout_targets(dataset, 0, num_windows)
    targets_t = torch.from_numpy(targets)

    os.makedirs(args.out, exist_ok=True)
    fields = data_cfg["output_fields"]
    rel = relative_l2_per_field(preds, targets_t).numpy()
    try:
        import matplotlib  # noqa: F401

        plot = True
    except ImportError:
        plot = False
        print("matplotlib does not import: no plots")
    if plot:
        plot_curves(args.out, timesteps, {name: rel[:, c] for c, name in enumerate(fields)},
                    "relative L2", "Rollout relative L2 per field", "relative_l2.png")
    if "dfun" in fields and plot:
        c = fields.index("dfun")
        plot_curves(args.out, timesteps,
                    {"model": eikonal_residual_per_step(preds[:, c]).numpy(),
                     "simulation": eikonal_residual_per_step(targets_t[:, c]).numpy()},
                    "eikonal residual", "Eikonal residual of the SDF over time", "eikonal.png")
        plot_curves(args.out, timesteps,
                    {"model": vapor_fraction(preds[:, c]).numpy(),
                     "simulation": vapor_fraction(targets_t[:, c]).numpy()},
                    "vapor fraction", "Mass conservation: vapor fraction over time",
                    "vapor_fraction.png")
    np.savez(os.path.join(args.out, "rollout_eval.npz"), preds=preds.numpy(), targets=targets,
             timesteps=timesteps, relative_l2=rel)
    print(f"wrote evaluation to {args.out}")


if __name__ == "__main__":
    main()
