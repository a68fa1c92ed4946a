#!/usr/bin/env python3
"""Heat-flux distribution analysis: simulation vs model rollout (PyTorch port).

Counterpart of ``examples/heatflux_analysis.py`` on the port's physics
functions: the per-frame wall heat flux of simulated and predicted (dfun,
temperature) fields, gaussian KDEs of both, their two PDFs plotted (where
matplotlib imports) and KL(sim || model) by Simpson integration.  Host-side
numpy and scipy: no device.

    python examples/heatflux_analysis_torch.py --rollout rollout_eval/rollout_eval.npz \
        --heater-temp 95 --out heatflux_eval
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from bubbleformer_tpu_torch.utils.heatflux import heatflux
from bubbleformer_tpu_torch.utils.metrics import heatflux_kl_divergence


def per_frame_fluxes(dfun: np.ndarray, temp: np.ndarray, heater_temp: float) -> np.ndarray:
    """Wall heat flux per frame (mean over the wall row), (T,)."""
    return np.asarray([heatflux(dfun[t : t + 1], temp[t : t + 1], heater_temp)[0]
                       for t in range(dfun.shape[0])])


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rollout", required=True,
                    help="npz from examples/autoregressive_rollout_torch.py")
    ap.add_argument("--heater-temp", type=float, required=True)
    ap.add_argument("--sdf-index", type=int, default=0)
    ap.add_argument("--temp-index", type=int, default=1)
    ap.add_argument("--out", default="heatflux_eval")
    args = ap.parse_args(argv)

    data = np.load(args.rollout)
    preds, targets = data["preds"], data["targets"]
    sim_fluxes = per_frame_fluxes(targets[:, args.sdf_index], targets[:, args.temp_index],
                                  args.heater_temp)
    model_fluxes = per_frame_fluxes(preds[:, args.sdf_index], preds[:, args.temp_index],
                                    args.heater_temp)
    print(f"sim  heat flux: mean {sim_fluxes.mean():.3f} max {sim_fluxes.max():.3f}")
    print(f"model heat flux: mean {model_fluxes.mean():.3f} max {model_fluxes.max():.3f}")
    try:
        kl = heatflux_kl_divergence(sim_fluxes, model_fluxes)
    except ValueError as e:
        print(f"KL analysis not applicable: {e}")
        return float("nan")
    print(f"KL(sim || model) = {kl:.5f}")

    try:
        import matplotlib
    except ImportError:
        print("matplotlib does not import: no plot")
        return kl
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.stats import gaussian_kde

    os.makedirs(args.out, exist_ok=True)
    lo = min(sim_fluxes.min(), model_fluxes.min())
    hi = max(sim_fluxes.max(), model_fluxes.max())
    span = (hi - lo) or 1.0
    xs = np.linspace(lo - 0.1 * span, hi + 0.1 * span, 512)
    plt.figure(figsize=(10, 6))
    plt.plot(xs, gaussian_kde(sim_fluxes)(xs), label="simulation")
    plt.plot(xs, gaussian_kde(model_fluxes)(xs), label="model")
    plt.xlabel("wall heat flux"), plt.ylabel("density"), plt.legend(), plt.grid(True)
    plt.title(f"Heat-flux PDFs, KL(sim||model) = {kl:.4f}")
    plt.savefig(os.path.join(args.out, "heatflux_pdfs.png")), plt.close()
    return kl


if __name__ == "__main__":
    main()
