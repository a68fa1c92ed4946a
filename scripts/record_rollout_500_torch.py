#!/usr/bin/env python3
"""The 500-step rollout of the PyTorch port, timed, with its metric curves.

Counterpart of ``scripts/record_rollout_500.py``: restores a checkpoint of
``scripts/train_torch.py`` (or a bare state dict of the model, as
``scripts/inference_torch.py`` does), rolls out ``--steps // time_window``
windows from the first window of ``--data`` (a trajectory's ``.hdf5``, or its
``.npy`` field caches beside it) through
``inference/rollout.py:make_rollout_metrics_fn`` — each window reduced to its
relative L2, eikonal residual and vapor-fraction drift as the rollout goes,
no stack of predictions kept — and writes frames/s (one window of warm-up,
then the whole rollout timed, CUDA-synchronised) and the per-window curves
with their first, middle and last values to ``--out``.  The trajectory must
hold ``start_time + (windows + 1) * time_window`` frames.

    python scripts/record_rollout_500_torch.py --ckpt logs/run/last.pt \\
        --data samples/sample_2.hdf5 --model-cfg avit_small --compute-dtype bfloat16
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

CURVES = ("rel_l2", "eikonal", "vapor_drift")


def window_curves(out) -> dict:
    """Per-window means of a metrics rollout's ``rel_l2`` ``(W, T, C)``,
    ``eikonal`` and ``vapor_drift`` ``(W, T)``: each a ``(W,)`` array."""
    return {k: np.asarray(out[k], dtype=np.float64).reshape(len(out[k]), -1).mean(axis=1)
            for k in CURVES if k in out}


def rollout_500(model, dataset, num_windows: int, device, dfun_index, conditioned: bool):
    """The metrics rollout of ``num_windows`` windows from ``dataset[0]`` on
    ``device``: its curves (:func:`window_curves`) and seconds (after one
    warm-up window)."""
    from bubbleformer_tpu_torch.inference import make_rollout_metrics_fn, rollout_targets

    first = dataset[0]
    init = torch.from_numpy(first[0])[None].to(device)
    cond = torch.from_numpy(first[2])[None].to(device) if conditioned else None
    targets, _ = rollout_targets(dataset, 0, num_windows)
    tw = dataset.time_window
    tgt = torch.from_numpy(targets).reshape(num_windows, tw, *targets.shape[1:])[:, None]
    tgt = tgt.to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    make_rollout_metrics_fn(model, 1, dfun_index=dfun_index, conditioned=conditioned)(
        init, tgt[:1], cond)
    sync()
    fn = make_rollout_metrics_fn(model, num_windows, dfun_index=dfun_index,
                                 conditioned=conditioned)
    t0 = time.perf_counter()
    out = fn(init, tgt, cond)
    sync()
    seconds = time.perf_counter() - t0
    return window_curves({k: v.float().cpu().numpy() for k, v in out.items()}), seconds


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--model-cfg", default="avit_small")
    ap.add_argument("--data-cfg", default="samples_smoke")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--start-time", type=int, default=5)
    ap.add_argument("--compute-dtype", default=None, choices=[None, "bfloat16"])
    ap.add_argument("--device", default="cuda",
                    help="torch device; without a CUDA card, pass --device cpu")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "rollout_500_torch.json"))
    args = ap.parse_args(argv)

    from bubbleformer_tpu_torch.config import load_config
    from bubbleformer_tpu_torch.data import BubbleForecast
    from bubbleformer_tpu_torch.training import module_class, resolve_device
    from scripts.inference_torch import restore_model

    device = resolve_device(args.device)
    cfg = load_config([f"model_cfg={args.model_cfg}", f"data_cfg={args.data_cfg}"])
    data_cfg = dict(cfg["data_cfg"], start_time=args.start_time)
    dataset = BubbleForecast(
        filenames=[args.data], input_fields=data_cfg["input_fields"],
        output_fields=data_cfg["output_fields"], norm="none",
        downsample_factor=data_cfg["downsample_factor"], time_window=data_cfg["time_window"],
        start_time=args.start_time, return_fluid_params=data_cfg["return_fluid_params"])
    model = restore_model(args.ckpt, cfg["model_cfg"], data_cfg, dataset,
                          args.compute_dtype).to(device)
    conditioned = module_class(cfg["model_cfg"], data_cfg).conditioned
    tw = dataset.time_window
    num_windows = args.steps // tw
    dfun = data_cfg["output_fields"].index("dfun")
    curves, seconds = rollout_500(model, dataset, num_windows, device, dfun, conditioned)

    result = {
        "model": args.model_cfg,
        "grid": list(dataset[0][0].shape[-2:]),
        "compute_dtype": args.compute_dtype or "float32",
        "steps": num_windows * tw,
        "windows": num_windows,
        "time_window": tw,
        "seconds": seconds,
        "frames_per_s": num_windows * tw / seconds,
        "in_scan_metrics": True,
        "curves_mean_per_window": {
            k: {"first": float(a[0]), "mid": float(a[num_windows // 2]), "last": float(a[-1]),
                "finite": bool(np.isfinite(a).all()), "per_window": a.tolist()}
            for k, a in curves.items()},
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None,
    }
    print(json.dumps({k: v for k, v in result.items() if k != "curves_mean_per_window"}))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
