"""The port's examples on the CPU: ``examples/autoregressive_rollout_torch.py``
from a bare state dict of AViT-tiny over ``.npy`` caches (no h5py), and
``examples/heatflux_analysis_torch.py`` against the JAX example's per-frame
heat flux and KL divergence on the same arrays (float64 numpy and scipy on
both sides: relative 1e-9).
"""
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bubbleformer_tpu.utils.metrics import heatflux_kl_divergence as jax_kl
from bubbleformer_tpu_torch.config import load_config
from bubbleformer_tpu_torch.models import build_model
from bubbleformer_tpu_torch.utils.metrics import relative_l2_per_field

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from examples import autoregressive_rollout_torch, heatflux_analysis_torch  # noqa: E402
from examples.heatflux_analysis import per_frame_fluxes as jax_per_frame_fluxes  # noqa: E402
from scripts import make_sample_data_torch  # noqa: E402

FIELDS = ["dfun", "temperature", "velx", "vely"]


def test_autoregressive_rollout_example(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    make_sample_data_torch.main(["--out", str(tmp_path), "--n", "1", "--frames", "30",
                                 "--size", "16", "--format", "npy"])
    torch.manual_seed(0)
    cfg = {"input_fields": FIELDS, "output_fields": FIELDS, "time_window": 5}
    model = build_model(load_config(["model_cfg=avit_tiny"])["model_cfg"], cfg)
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    out = tmp_path / "eval"
    autoregressive_rollout_torch.main([
        "--ckpt", str(tmp_path / "weights.pt"), "--data", str(tmp_path / "sample_1.hdf5"),
        "--model-cfg", "avit_tiny", "--data-cfg", "samples_smoke", "--steps", "15",
        "--start-time", "2", "--out", str(out), "--device", "cpu"])
    saved = np.load(out / "rollout_eval.npz")
    assert saved["preds"].shape == saved["targets"].shape == (15, 4, 16, 16)
    np.testing.assert_array_equal(saved["timesteps"], np.arange(7, 22))
    np.testing.assert_allclose(saved["relative_l2"], relative_l2_per_field(
        torch.from_numpy(saved["preds"]), torch.from_numpy(saved["targets"])).numpy(), rtol=1e-6)
    plots = sorted(p.name for p in out.glob("*.png"))
    assert plots == ([] if importlib.util.find_spec("matplotlib") is None else
                     ["eikonal.png", "relative_l2.png", "vapor_fraction.png"])


def test_heatflux_analysis_example_matches_jax(tmp_path):
    # 128 px at the default dx of 1/32 reach the heater (x >= -5).
    fields = make_sample_data_torch.bubble_trajectory(8, 128, 0)
    targets = np.stack([fields[f] for f in FIELDS], axis=1)
    preds = targets.copy()
    preds[:, 1] += np.random.default_rng(0).normal(0.0, 2.0, preds[:, 1].shape)
    np.savez(tmp_path / "rollout_eval.npz", preds=preds, targets=targets)
    kl = heatflux_analysis_torch.main(["--rollout", str(tmp_path / "rollout_eval.npz"),
                                       "--heater-temp", "95", "--out", str(tmp_path / "hf")])
    for a in (targets, preds):
        np.testing.assert_allclose(heatflux_analysis_torch.per_frame_fluxes(a[:, 0], a[:, 1], 95),
                                   jax_per_frame_fluxes(a[:, 0], a[:, 1], 95), rtol=1e-12)
    want = jax_kl(jax_per_frame_fluxes(targets[:, 0], targets[:, 1], 95),
                  jax_per_frame_fluxes(preds[:, 0], preds[:, 1], 95))
    assert np.isfinite(kl) and kl == pytest.approx(want, rel=1e-9)
