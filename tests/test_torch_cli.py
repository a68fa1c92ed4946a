"""``scripts/inference_torch.py`` end to end on synthetic trajectories from
``scripts/make_sample_data.py``, with a state dict the bridge wrote from JAX
film_avit_tiny params: its predictions against the JAX rollout of the same
params from the same first window (float32; the tolerance is stated where it
is checked), and its metrics-only mode against its own predictions.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.config import load_config as jax_load_config
from bubbleformer_tpu.data import BubbleForecast as JaxForecast
from bubbleformer_tpu.inference import make_rollout_fn as jax_make_rollout_fn
from bubbleformer_tpu.models import get_model as jax_get_model
from bubbleformer_tpu_torch.utils.convert import jax_params_to_state_dict

REPO = Path(__file__).resolve().parents[1]
STEPS, START = 10, 5


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    subprocess.run(
        [sys.executable, str(REPO / "scripts" / "make_sample_data.py"), "--out", str(tmp),
         "--n", "2", "--frames", "24", "--size", "64"],
        check=True, capture_output=True, timeout=120,
    )
    cfg = jax_load_config(["model_cfg=film_avit_tiny", "data_cfg=singlebubble"])
    data = str(tmp / "sample_2.hdf5")
    ds = JaxForecast([data], input_fields=cfg["data_cfg"]["input_fields"],
                     output_fields=cfg["data_cfg"]["output_fields"], time_window=5,
                     start_time=START, return_fluid_params=True)
    ds.normalize()
    inp, _, cond = ds[0]
    ref = jax_get_model(cfg["model_cfg"]["name"], **cfg["model_cfg"]["params"], input_fields=4,
                        output_fields=4, time_window=5)
    variables = ref.init(jax.random.key(0), jnp.asarray(inp[None]), jnp.asarray(cond[None]))
    rng = np.random.default_rng(0)

    def act(path, leaf):
        """LayerScale gammas at O(0.1-1), FiLM near identity (as in
        tests/test_torch_rollout.py)."""
        name = jax.tree_util.keystr(path)
        if "gamma" in name:
            return jnp.asarray(rng.uniform(0.2, 0.6, leaf.shape).astype(np.float32))
        if "film_embed" in name and "proj" in name:
            c = leaf.shape[-1] // 2
            return 0.1 * leaf if "kernel" in name else jnp.concatenate(
                [jnp.ones(c), jnp.zeros(c)])
        return leaf

    variables = jax.tree_util.tree_map_with_path(act, variables)
    ckpt = tmp / "film_avit_tiny.pt"
    torch.save(jax_params_to_state_dict(variables), ckpt)

    def cli(*extra):
        out = tmp / ("out" + "".join(extra).replace("-", "_"))
        proc = subprocess.run(
            [sys.executable, str(REPO / "scripts" / "inference_torch.py"), "--ckpt", str(ckpt),
             "--data", data, "--model-cfg", "film_avit_tiny", "--data-cfg", "singlebubble",
             "--steps", str(STEPS), "--start-time", str(START), "--save-dir", str(out),
             "--device", "cpu", *extra],
            capture_output=True, text=True, timeout=300, cwd=tmp,
            # The two runs are compared bit for bit: MKL must not pick its
            # thread count from the machine's load (which reorders sums).
            env=dict(os.environ, MKL_DYNAMIC="FALSE", OMP_DYNAMIC="FALSE"),
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        return proc.stdout, out

    want = jax_make_rollout_fn(ref, STEPS // 5, conditioned=True)(
        variables, jnp.asarray(inp[None]), jnp.asarray(cond[None]))
    return cli(), cli("--in-scan-metrics"), np.asarray(want)[:, 0].reshape(STEPS, 4, 64, 64)


def test_rollout_cli_matches_jax_rollout(run):
    (stdout, out), _, want = run
    for line in ("window 0: relative L2 = ", "window 1: relative L2 = ",
                 "eikonal residual (mean over rollout): ", "vapor-fraction drift: ",
                 "saved rollout to "):
        assert line in stdout, stdout
    saved = np.load(out / "predictions.npz")
    assert saved["preds"].shape == saved["targets"].shape == (STEPS, 4, 64, 64)
    np.testing.assert_array_equal(saved["timesteps"], np.arange(START + 5, START + 5 + STEPS))
    # The CLI reads the data unnormalized, as scripts/inference.py does: the
    # temperature field has mean ~63 and spread ~6, so the embed's first
    # single-pass float32 InstanceNorm works near cancellation, where XLA's CPU
    # reduction is the less accurate one (at a mean/spread ratio of 10 its
    # InstanceNorm is 7x further from a float64 evaluation than the port's).
    # Measured 1.4e-4 of max|out| here, against 1e-6 on standardized inputs.
    err = np.abs(saved["preds"] - want).max()
    assert err <= 1e-3 * np.abs(want).max(), err


def test_in_scan_metrics_cli_matches_its_predictions(run):
    (stdout_p, out_p), (stdout_m, out_m), _ = run
    assert "saved rollout metrics to " in stdout_m
    # The per-window relative L2 lines agree with the post-hoc mode's.
    lines = [ln for ln in stdout_m.splitlines() if ln.startswith("window ")]
    assert lines == [ln for ln in stdout_p.splitlines() if ln.startswith("window ")]
    metrics = np.load(out_m / "metrics.npz")
    preds = np.load(out_p / "predictions.npz")["preds"]
    np.testing.assert_allclose(metrics["final_window"][0], preds[-5:], rtol=0, atol=0)
    assert metrics["rel_l2"].shape == (STEPS // 5, 5, 4)
    assert metrics["eikonal"].shape == metrics["vapor_drift"].shape == (STEPS // 5, 5)
