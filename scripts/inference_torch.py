#!/usr/bin/env python3
"""Autoregressive rollout inference with the PyTorch port.

Counterpart of ``scripts/inference.py`` on ``bubbleformer_tpu_torch``, with
the same flags plus ``--device``.  The rollout runs on ``--device`` (default
``cuda``, through the port's CUDA kernels); without a CUDA card it raises
unless ``--device cpu`` asks for the CPU (the kernels' plain versions).

``--ckpt`` is either a checkpoint of ``scripts/train_torch.py`` (its model
weights and the normalization constants it was trained with, which the data
are then normalized by, as ``scripts/inference.py`` does) or a bare
``torch.save``d state dict of the port's model, such as
``bubbleformer_tpu_torch.utils.convert.jax_params_to_state_dict`` writes
from JAX params (Orbax checkpoints cannot be read without JAX); a bare state
dict carries no constants, so the data are read unnormalized.

    python scripts/inference_torch.py --ckpt logs/run/last.pt --data test.hdf5 \
        --model-cfg film_avit_small --steps 500 --save-dir out/
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
from bubbleformer_tpu_torch.inference import (
    make_rollout_fn,
    make_rollout_metrics_fn,
    rollout_targets,
    window_relative_l2,
)
from bubbleformer_tpu_torch.models import build_model
from bubbleformer_tpu_torch.training import load_checkpoint, module_class, resolve_device
from bubbleformer_tpu_torch.utils.metrics import (
    eikonal_residual_per_step,
    mass_conservation_drift,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help="train_torch.py checkpoint, or a torch.save'd state dict of the model")
    ap.add_argument("--data", required=True, help="trajectory HDF5 to roll out on")
    ap.add_argument("--model-cfg", default="avit_small", help="model config group name")
    ap.add_argument("--data-cfg", default="singlebubble", help="data config group name")
    ap.add_argument("--steps", type=int, default=500, help="total rollout timesteps")
    ap.add_argument("--start-time", type=int, default=100)
    ap.add_argument("--save-dir", default="rollout_out")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument(
        "--in-scan-metrics",
        action="store_true",
        help="reduce each window to its physics metrics as the rollout goes instead of "
        "stacking all predictions in device memory (no predictions.npz)",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on; without a CUDA card, pass --device cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config([f"model_cfg={args.model_cfg}", f"data_cfg={args.data_cfg}"])
    data_cfg = dict(cfg["data_cfg"])
    data_cfg["start_time"] = args.start_time

    dataset = BubbleForecast(
        filenames=[args.data],
        input_fields=data_cfg["input_fields"],
        output_fields=data_cfg["output_fields"],
        norm="none",
        downsample_factor=data_cfg["downsample_factor"],
        time_window=data_cfg["time_window"],
        start_time=args.start_time,
        return_fluid_params=data_cfg["return_fluid_params"],
    )
    state = torch.load(args.ckpt, map_location="cpu", weights_only=True)
    if "format_version" in state:  # a training checkpoint
        state = load_checkpoint(args.ckpt)
        if state["norm_constants"] is not None:
            dataset.normalize(*state["norm_constants"])
        state = state["model"]
    tw = dataset.time_window
    num_windows = args.steps // tw
    # The model decides: fluid parameters the data return to a model
    # without FiLM are left unused, as in training.
    conditioned = module_class(cfg["model_cfg"], data_cfg).conditioned

    model = build_model(cfg["model_cfg"], data_cfg)
    model.load_state_dict(state)
    model = model.eval().to(device)

    first = dataset[0]
    init_window = torch.from_numpy(first[0])[None].to(device)
    cond = torch.from_numpy(first[2])[None].to(device) if conditioned else None
    targets, timesteps = rollout_targets(dataset, 0, num_windows)
    sdf_idx = (
        data_cfg["output_fields"].index("dfun") if "dfun" in data_cfg["output_fields"] else None
    )

    if args.in_scan_metrics:
        fn = make_rollout_metrics_fn(model, num_windows, dfun_index=sdf_idx,
                                     conditioned=conditioned)
        # (num_windows * tw, C, H, W) -> (num_windows, 1, tw, C, H, W)
        tgt = torch.from_numpy(targets).reshape(num_windows, tw, *targets.shape[1:])[:, None]
        out = fn(init_window, tgt.to(device), cond)
        for k in range(num_windows):
            print(f"window {k}: relative L2 = {float(out['rel_l2'][k].mean()):.4f}")
        if sdf_idx is not None:
            print(f"eikonal residual (mean over rollout): {float(out['eikonal'].mean()):.4f}")
            print(f"vapor-fraction drift: {float(out['vapor_drift'].mean()):.5f}")
        os.makedirs(args.save_dir, exist_ok=True)
        np.savez(
            os.path.join(args.save_dir, "metrics.npz"),
            timesteps=timesteps,
            **{k: v.float().cpu().numpy() for k, v in out.items()},
        )
        print(f"saved rollout metrics to {args.save_dir}")
        return

    preds = make_rollout_fn(model, num_windows, conditioned=conditioned)(init_window, cond)
    # (num_windows, 1, T, C, H, W) -> (num_windows*T, C, H, W)
    preds = preds[:, 0].reshape(-1, *preds.shape[3:]).float().cpu()
    targets_t = torch.from_numpy(targets)

    # The in-scan mode's arithmetic (the reference's LpLoss(d=2, p=2,
    # reduce_dims=[0, 1], reductions=[mean, mean]) in one order), so both
    # modes print the same lines for the same predictions.
    for k in range(num_windows):
        sl = slice(k * tw, (k + 1) * tw)
        rel = window_relative_l2(preds[sl][None], targets_t[sl][None])
        print(f"window {k}: relative L2 = {float(rel.mean()):.4f}")

    if sdf_idx is not None:
        eik = eikonal_residual_per_step(preds[:, sdf_idx])
        drift = mass_conservation_drift(preds[:, sdf_idx], targets_t[:, sdf_idx])
        print(f"eikonal residual (mean over rollout): {float(eik.mean()):.4f}")
        print(f"vapor-fraction drift: {float(drift):.5f}")

    preds = preds.numpy()
    os.makedirs(args.save_dir, exist_ok=True)
    np.savez(
        os.path.join(args.save_dir, "predictions.npz"),
        preds=preds,
        targets=targets,
        timesteps=timesteps,
    )
    if args.plot:
        from bubbleformer_tpu_torch.utils.plot_utils import plot_bubbleml

        plot_bubbleml(preds, targets, timesteps, args.save_dir)
    print(f"saved rollout to {args.save_dir}")


if __name__ == "__main__":
    main()
