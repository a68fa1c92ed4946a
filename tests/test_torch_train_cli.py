"""``scripts/train_torch.py`` end to end on the CPU (``device=cpu``) over
``scripts/make_sample_data.py`` trajectories: two steps of film_avit_tiny
with the default composition's Lion, cosine warmup and bfloat16
activations write ``metrics.csv`` and a checkpoint with the training
normalization constants; ``scripts/inference_torch.py --device cpu`` then
rolls out from that checkpoint, normalizing its data with those constants.
Both scripts refuse to run without a card unless asked for the CPU.
"""
import csv
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bubbleformer_tpu_torch.config import load_config
from bubbleformer_tpu_torch.data import BubbleForecast
from bubbleformer_tpu_torch.inference import make_rollout_fn
from bubbleformer_tpu_torch.models import build_model
from bubbleformer_tpu_torch.training import load_checkpoint

REPO = Path(__file__).resolve().parents[1]
STEPS, START = 10, 5


def _run(script, *args, cwd):
    return subprocess.run([sys.executable, str(REPO / "scripts" / script), *map(str, args)],
                          capture_output=True, text=True, timeout=300, cwd=cwd)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_cli")
    subprocess.run(
        [sys.executable, str(REPO / "scripts" / "make_sample_data.py"), "--out", str(tmp),
         "--n", "2", "--frames", "24", "--size", "64"],
        check=True, capture_output=True, timeout=120,
    )
    proc = _run("train_torch.py", "device=cpu", "model_cfg=film_avit_tiny",
                f"data_cfg.train_paths=[{tmp / 'sample_1.hdf5'}]",
                f"data_cfg.val_paths=[{tmp / 'sample_2.hdf5'}]", "data_cfg.normalize=std",
                f"data_cfg.start_time={START}", "batch_size=2", "max_epochs=1",
                "limit_train_batches=2", "limit_val_batches=1", "seed=3",
                f"log_dir={tmp / 'logs'}", cwd=tmp)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return tmp, proc.stdout, tmp / "logs" / "filmavit_singlebubble_saturated_local"


def test_train_cli_writes_metrics_and_a_checkpoint(trained):
    _, stdout, log_dir = trained
    assert "epoch 0: 2 steps" in stdout and "total" in stdout
    rows = list(csv.DictReader(open(log_dir / "metrics.csv")))
    assert [r["split"] for r in rows] == ["train", "val"]
    assert float(rows[0]["learning_rate"]) == 0.0  # cosine warmup: lr(0) = 0
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    ckpt = load_checkpoint(str(log_dir / "last.pt"))
    assert ckpt["step"] == 2
    diff, div = ckpt["norm_constants"]
    assert set(diff) == {"dfun", "temperature", "velx", "vely"}
    assert div["temperature"] > 1.0 and diff["temperature"] > 10.0
    assert any(v.dtype == torch.float32 for v in ckpt["model"].values())


def test_rollout_cli_uses_the_checkpoint_and_its_constants(trained):
    tmp, _, log_dir = trained
    out = tmp / "rollout"
    proc = _run("inference_torch.py", "--ckpt", log_dir / "last.pt", "--data",
                tmp / "sample_2.hdf5", "--model-cfg", "film_avit_tiny", "--data-cfg",
                "singlebubble", "--steps", STEPS, "--start-time", START, "--save-dir", out,
                "--device", "cpu", cwd=tmp)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "window 1: relative L2 = " in proc.stdout
    preds = np.load(out / "predictions.npz")["preds"]

    ckpt = load_checkpoint(str(log_dir / "last.pt"))
    cfg = load_config(["model_cfg=film_avit_tiny", "data_cfg=singlebubble"])
    ds = BubbleForecast([str(tmp / "sample_2.hdf5")], time_window=5, start_time=START,
                        return_fluid_params=True)
    ds.normalize(*ckpt["norm_constants"])
    model = build_model(cfg["model_cfg"], cfg["data_cfg"])
    model.load_state_dict(ckpt["model"])
    inp, _, cond = ds[0]
    want = make_rollout_fn(model.eval(), STEPS // 5, conditioned=True)(
        torch.from_numpy(inp)[None], torch.from_numpy(cond)[None])
    # The CLI's process and this one may split MKL's sums over other thread
    # counts: float32 reassociation through 2 windows, 1e-5 of max|out|.
    want = want[:, 0].reshape(STEPS, 4, 64, 64).numpy()
    assert np.abs(preds - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("script,args", [
    ("train_torch.py", ["synthetic_batches=1"]),
    ("inference_torch.py", ["--ckpt", "x.pt", "--data", "x.hdf5"]),
])
def test_entry_points_refuse_to_fall_back_to_the_cpu(script, args, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    proc = _run(script, *args, cwd=tmp_path)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
