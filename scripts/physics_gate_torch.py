#!/usr/bin/env python3
"""End-to-end physics gate of the PyTorch port: train -> rollout -> physics
metrics -> tolerances.

Counterpart of ``scripts/physics_gate.py`` with its ``TOLERANCES`` (copied,
never loosened), sample counts and training overrides: two synthetic
boiling-shaped trajectories of 80 frames at 64x64
(``scripts/make_sample_data_torch.py``, written as ``.npy`` caches with numpy
alone), an AViT-tiny trained through ``scripts/train_torch.py`` (``auto``:
the temporal branch unrolled, the axial branch on K4 at head dim 16; the
native loader), then ``--windows`` rollout windows on the held-out
trajectory through ``inference/rollout.py``, beside the untrained model's
rollout (the trivial baseline), and the metrics :func:`gate_metrics`
computes: per-window relative L2, the eikonal residual of the SDF, the
vapor-fraction drift, the wall heat flux of the denormalized fields and the
KL divergence of the per-frame heat-flux distributions.  Runs on the card
(``--device cuda``, the default; ``--device cpu`` asks for the CPU), writes
its JSON to ``--out`` and exits 1 when a tolerance fails.  ``--init-weights``
trains from a given state dict instead of the port's seeded init (and takes
it as the untrained baseline), such as the JAX package's init bridged by
``utils/convert.py:jax_params_to_state_dict``; ``--seed`` sets the training
seed (the port's init and the loader's shuffle; the config's 42 by default).

    python scripts/physics_gate_torch.py
    python scripts/physics_gate_torch.py --device cpu --epochs 2 --train-batches 4 \\
        --out chiprun_out/physics_cpu.json
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

# scripts/physics_gate.py:54-61, with the measurements they were set from.
TOLERANCES = {
    "rollout_rel_l2_final_max": 1.0,   # must beat the zero predictor
    "untrained_improvement_min": 0.9,  # mean rel-L2 < 0.9x untrained
    "eikonal_residual_max": 60.0,      # 2x the r03-measured 29.4
    "vapor_fraction_drift_max": 0.5,
    "heatflux_mean_ratio_band": 2.0,   # 2x rule; r04 measured ratio 1.06
    "heatflux_kl_max": 5.0,            # ~1.35x the r04-measured 3.71
}
SAMPLES = ["--n", "2", "--frames", "80"]  # at make_sample_data's 64x64
ROLLOUT_START = 5
METRIC_KEYS = (
    "rollout_rel_l2_per_window", "rollout_rel_l2_final", "rollout_rel_l2_mean",
    "rollout_rel_l2_untrained_per_window", "rollout_rel_l2_untrained_mean",
    "eikonal_residual_mean", "vapor_fraction_drift", "heatflux_pred_mean",
    "heatflux_pred_max", "heatflux_sim_mean", "heatflux_sim_max", "heatflux_kl_sim_vs_model",
    "tolerances", "ok", "failures",
)


def gate_metrics(preds: np.ndarray, preds_untrained: np.ndarray, targets: np.ndarray,
                 fields, diff_terms, div_terms, heater_temp: float) -> dict:
    """The gate's metrics and verdict from ``(windows, T, C, H, W)`` rollouts
    of the trained and the untrained model and their targets (normalized
    by ``diff_terms``, ``div_terms``): ``scripts/physics_gate.py:165-268``
    on the port's metric functions, the numbers unrounded."""
    from bubbleformer_tpu_torch.utils.heatflux import heatflux_series
    from bubbleformer_tpu_torch.utils.losses import LpLoss
    from bubbleformer_tpu_torch.utils.metrics import (
        eikonal_residual_per_step,
        heatflux_kl_divergence,
        mass_conservation_drift,
    )

    lp = LpLoss(d=2, p=2, reduce_dims=[0, 1], reductions=["mean", "mean"])
    tgt = torch.from_numpy(np.ascontiguousarray(targets, dtype=np.float32))

    def rel_l2(p):
        p = torch.from_numpy(np.ascontiguousarray(p, dtype=np.float32))
        return [float(lp(p[i], tgt[i])) for i in range(p.shape[0])]

    rel, rel_untrained = rel_l2(preds), rel_l2(preds_untrained)
    dfun_idx, temp_idx = fields.index("dfun"), fields.index("temperature")
    flat_pred = preds.reshape(-1, *preds.shape[2:])  # (W*T, C, H, W)
    flat_tgt = targets.reshape(-1, *targets.shape[2:])
    pred_dfun = torch.from_numpy(np.ascontiguousarray(flat_pred[:, dfun_idx], np.float32))
    eik = eikonal_residual_per_step(pred_dfun).numpy()
    drift = float(mass_conservation_drift(
        pred_dfun, torch.from_numpy(np.ascontiguousarray(flat_tgt[:, dfun_idx], np.float32))))

    # Heat flux on denormalized fields: std normalization shifts dfun's zero
    # level, which the flux's liquid mask depends on.  The synthetic [0, 1]^2
    # domain maps onto the reference heater geometry (x in [-8, 8]).
    def denorm(a, field):
        return a * div_terms[field] + diff_terms[field]

    hf_kwargs = dict(heater_temp=heater_temp, dx=16.0 / flat_pred.shape[-1], x_min=-8.0)
    hf_pred = heatflux_series(denorm(flat_pred[:, dfun_idx], "dfun"),
                              denorm(flat_pred[:, temp_idx], "temperature"), **hf_kwargs)
    hf_sim = heatflux_series(denorm(flat_tgt[:, dfun_idx], "dfun"),
                             denorm(flat_tgt[:, temp_idx], "temperature"), **hf_kwargs)
    try:
        hf_kl = heatflux_kl_divergence(hf_sim, hf_pred)
    except ValueError:
        hf_kl = float("nan")

    mean_trained, mean_untrained = float(np.mean(rel)), float(np.mean(rel_untrained))
    hf_pm, hf_sm = float(np.mean(hf_pred)), float(np.mean(hf_sim))
    metrics = {
        "rollout_rel_l2_per_window": rel,
        "rollout_rel_l2_final": rel[-1],
        "rollout_rel_l2_mean": mean_trained,
        "rollout_rel_l2_untrained_per_window": rel_untrained,
        "rollout_rel_l2_untrained_mean": mean_untrained,
        "eikonal_residual_mean": float(eik.mean()),
        "vapor_fraction_drift": drift,
        "heatflux_pred_mean": hf_pm,
        "heatflux_pred_max": float(np.max(hf_pred)),
        "heatflux_sim_mean": hf_sm,
        "heatflux_sim_max": float(np.max(hf_sim)),
        "heatflux_kl_sim_vs_model": float(hf_kl) if np.isfinite(hf_kl) else None,
        "tolerances": TOLERANCES,
    }

    failures = []
    if rel[-1] > TOLERANCES["rollout_rel_l2_final_max"]:
        failures.append(f"final rel_l2 {rel[-1]:.3f} > "
                        f"{TOLERANCES['rollout_rel_l2_final_max']} (zero-predictor level)")
    if mean_trained > TOLERANCES["untrained_improvement_min"] * mean_untrained:
        failures.append(f"mean rel_l2 {mean_trained:.3f} not < "
                        f"{TOLERANCES['untrained_improvement_min']}x untrained "
                        f"{mean_untrained:.3f} (no learning)")
    if not np.isfinite(eik).all() or eik.mean() > TOLERANCES["eikonal_residual_max"]:
        failures.append(f"eikonal {eik.mean():.1f} > {TOLERANCES['eikonal_residual_max']}")
    if not np.isfinite(drift) or abs(drift) > TOLERANCES["vapor_fraction_drift_max"]:
        failures.append(f"drift {drift:.3f} > {TOLERANCES['vapor_fraction_drift_max']}")
    band = TOLERANCES["heatflux_mean_ratio_band"]
    if not (np.isfinite(hf_pred).all() and np.isfinite(hf_sim).all()):
        failures.append("non-finite heat flux in rollout")
    elif hf_sm <= 0.0:
        # The band is a ratio test and assumes a positive simulated flux.
        failures.append(f"sim mean heat flux {hf_sm:.2f} <= 0 (band undefined)")
    elif not (1.0 / band <= hf_pm / hf_sm <= band):
        failures.append(f"pred mean heat flux {hf_pm:.1f} outside {band}x band of sim {hf_sm:.1f}")
    if not np.isfinite(hf_kl) or hf_kl > TOLERANCES["heatflux_kl_max"]:
        failures.append(f"heat-flux KL {hf_kl} > {TOLERANCES['heatflux_kl_max']}")
    metrics["ok"] = not failures
    metrics["failures"] = failures
    return metrics


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("chiprun_out", "physics_gate_torch.json"))
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--train-batches", type=int, default=50)
    ap.add_argument("--warmup-iters", type=int, default=20)
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; without a CUDA card, pass --device cpu")
    ap.add_argument("--init-weights", default=None,
                    help="a torch.save'd AViT-tiny state dict to train from (and to take as "
                    "the untrained baseline) instead of the port's seeded init, e.g. the JAX "
                    "package's init through utils/convert.py:jax_params_to_state_dict")
    ap.add_argument("--seed", type=int, default=None,
                    help="the training seed (init and shuffle); default the config's")
    args = ap.parse_args(argv)

    from bubbleformer_tpu_torch.config import load_config
    from bubbleformer_tpu_torch.data import BubbleForecast
    from bubbleformer_tpu_torch.inference import make_rollout_fn, rollout_targets
    from bubbleformer_tpu_torch.models import build_model
    from bubbleformer_tpu_torch.training import (
        load_checkpoint,
        module_class,
        resolve_device,
        save_checkpoint,
    )
    from scripts.make_sample_data_torch import main as make_samples
    from scripts.train_torch import main as train_main

    device = resolve_device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="physics_gate_")
    samples_dir = os.path.join(workdir, "samples")
    make_samples(["--out", samples_dir, *SAMPLES, "--format", "npy"])

    # Train through the CLI (scripts/physics_gate.py:93-111's overrides).
    os.environ["BUBBLEML_SAMPLES"] = samples_dir
    log_dir = os.path.join(workdir, "logs")
    overrides = [
        "data_cfg=samples_smoke", "model_cfg=avit_tiny", "optim_cfg=adamw",
        f"max_epochs={args.epochs}", "batch_size=4",
        f"limit_train_batches={args.train_batches}", "limit_val_batches=2",
        f"log_dir={log_dir}", "use_wandb=false",
        # The default schedule warms up over 1000 iterations; the gate's
        # budget is a few hundred steps.
        f"scheduler_cfg.params.warmup_iters={args.warmup_iters}",
        f"device={device.type}",
    ]
    if args.seed is not None:
        overrides.append(f"seed={args.seed}")
    cfg = load_config(["model_cfg=avit_tiny", "data_cfg=samples_smoke", "optim_cfg=adamw"])
    data_cfg = dict(cfg["data_cfg"])
    if args.init_weights:
        # A step-0 checkpoint of those weights, resumed by the CLI; its
        # normalization constants stay the training data's.
        module = module_class(cfg["model_cfg"], data_cfg)(
            cfg["model_cfg"], data_cfg, cfg["optim_cfg"], cfg["scheduler_cfg"], total_steps=1,
            device="cpu")
        module.model.load_state_dict(torch.load(args.init_weights, map_location="cpu",
                                                weights_only=True))
        init_ckpt = os.path.join(log_dir, "from_init", "init.pt")
        save_checkpoint(init_ckpt, module)
        overrides.append(f"checkpoint_path={init_ckpt}")
    t0 = time.perf_counter()
    train_main(overrides)
    if device.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    (ckpt,) = glob.glob(os.path.join(log_dir, "*", "last.pt"))

    # The held-out trajectory, normalized by its own constants
    # (scripts/physics_gate.py:127-139).
    fields = data_cfg["output_fields"]
    dataset = BubbleForecast(
        filenames=[os.path.join(samples_dir, "sample_2.hdf5")],
        input_fields=data_cfg["input_fields"], output_fields=fields,
        norm=data_cfg["normalize"], downsample_factor=data_cfg["downsample_factor"],
        time_window=data_cfg["time_window"], start_time=ROLLOUT_START)
    dataset.normalize()
    tw = dataset.time_window
    targets_flat, _ = rollout_targets(dataset, 0, args.windows)
    targets = targets_flat.reshape(args.windows, tw, *targets_flat.shape[1:])
    init = torch.from_numpy(dataset[0][0])[None].to(device)

    trained = build_model(cfg["model_cfg"], data_cfg)
    state = load_checkpoint(ckpt)
    trained.load_state_dict(state["model"])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        untrained = build_model(cfg["model_cfg"], data_cfg)
    if args.init_weights:
        untrained.load_state_dict(load_checkpoint(init_ckpt)["model"])

    def rollout(model):
        model = model.eval().to(device)
        preds = make_rollout_fn(model, args.windows)(init)[:, 0]
        return preds.float().cpu().numpy()

    t0 = time.perf_counter()
    preds_untrained = rollout(untrained)
    preds = rollout(trained)
    rollout_s = time.perf_counter() - t0
    with open(os.path.join(samples_dir, "sample_2.json")) as f:
        heater_temp = float(json.load(f)["heater"]["wallTemp"])
    metrics = gate_metrics(preds, preds_untrained, targets, fields, dataset.diff_terms,
                           dataset.div_terms, heater_temp)
    metrics.update({
        "windows": args.windows, "time_window": tw, "train_epochs": args.epochs,
        "train_steps": state["step"], "train_batches_per_epoch": state["step"] // args.epochs,
        "seed": args.seed if args.seed is not None else cfg["seed"], "train_seconds": train_s,
        "rollout_seconds": rollout_s, "init_weights": args.init_weights, "device": str(device),
        "device_name": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
    })
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(metrics, f, indent=1)
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
