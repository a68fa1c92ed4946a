"""The U-Nets through the port's entry points on the CPU: ``scripts/
train_torch.py device=cpu model_cfg=unet_classic`` on ``scripts/
make_sample_data.py`` trajectories writes ``metrics.csv`` and a checkpoint
whose BatchNorm running statistics moved and restore; ``scripts/
inference_torch.py --device cpu`` rolls out from it in eval mode; the
trainer's preemption and non-finite checkpoints of a U-Net load back; the
full-width configs build with the JAX models' parameter counts; a misspelt
field raises, as the JAX dataclass does.
"""
import csv
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.models import get_model as jax_get_model
from bubbleformer_tpu_torch.config import load_config
from bubbleformer_tpu_torch.data import synthetic_batch
from bubbleformer_tpu_torch.models import build_model, get_model
from bubbleformer_tpu_torch.training import (
    ForecastModule,
    Trainer,
    load_checkpoint,
    module_class,
    next_preempt_ckpt_path,
    restore_checkpoint,
)
from tests.test_torch_training import ListLoader

REPO = Path(__file__).resolve().parents[1]
STEPS, START = 10, 5
DATA_CFG = {"input_fields": ["dfun", "temperature", "velx", "vely"],
            "output_fields": ["dfun", "temperature", "velx", "vely"], "time_window": 5}
LION = {"name": "lion", "params": {"lr": 1e-4, "weight_decay": 0.1}}
SCHED = {"name": "cosine_warmup", "params": {"warmup_iters": 1, "eta_min": 1e-6}}
TINY_CLASSIC = {"name": "unet_classic", "params": {"hidden_channels": 4}}


def _run(script, *args, cwd):
    return subprocess.run([sys.executable, str(REPO / "scripts" / script), *map(str, args)],
                          capture_output=True, text=True, timeout=300, cwd=cwd)


def running_stats(state_dict):
    return {k: v for k, v in state_dict.items() if k.endswith(("running_mean", "running_var"))}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """ClassicUnet at its config's full width (hidden 32, 7.8M parameters)
    on 64x64 frames: two Lion steps at batch 2 in bfloat16."""
    tmp = tmp_path_factory.mktemp("unet_cli")
    subprocess.run(
        [sys.executable, str(REPO / "scripts" / "make_sample_data.py"), "--out", str(tmp),
         "--n", "2", "--frames", "24", "--size", "64"],
        check=True, capture_output=True, timeout=120,
    )
    proc = _run("train_torch.py", "device=cpu", "model_cfg=unet_classic",
                f"data_cfg.train_paths=[{tmp / 'sample_1.hdf5'}]",
                f"data_cfg.val_paths=[{tmp / 'sample_2.hdf5'}]", "data_cfg.normalize=std",
                f"data_cfg.start_time={START}", "batch_size=2", "max_epochs=1",
                "limit_train_batches=2", "limit_val_batches=1", "seed=3",
                f"log_dir={tmp / 'logs'}", cwd=tmp)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return tmp, proc.stdout, tmp / "logs" / "unet_classic_singlebubble_saturated_local"


def test_train_cli_writes_metrics_and_a_checkpoint_that_restores_the_statistics(trained):
    _, stdout, log_dir = trained
    assert "epoch 0: 2 steps" in stdout
    rows = list(csv.DictReader(open(log_dir / "metrics.csv")))
    assert [r["split"] for r in rows] == ["train", "val"]
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    ckpt = load_checkpoint(str(log_dir / "last.pt"))
    assert ckpt["step"] == 2
    stats = running_stats(ckpt["model"])
    assert len(stats) == 2 * 18  # 9 blocks of 2 BatchNorms, mean and var each
    moved = [k for k, v in stats.items()
             if not torch.equal(v, torch.zeros_like(v) if k.endswith("mean") else torch.ones_like(v))]
    assert moved == list(stats)

    cfg = load_config(["model_cfg=unet_classic"])
    fresh = module_class(cfg["model_cfg"], cfg["data_cfg"])(
        cfg["model_cfg"], cfg["data_cfg"], cfg["optim_cfg"], cfg["scheduler_cfg"],
        total_steps=4, device="cpu")
    Trainer(fresh, log_dir=str(log_dir / "resume")).restore(str(log_dir / "last.pt"))
    assert fresh.step == 2 and fresh.normalization_constants is not None
    for k, v in running_stats(fresh.model.state_dict()).items():
        torch.testing.assert_close(v, stats[k], rtol=0, atol=0, msg=k)


def test_rollout_cli_rolls_the_unet_out_in_eval_mode(trained):
    tmp, _, log_dir = trained
    out = tmp / "rollout"
    proc = _run("inference_torch.py", "--ckpt", log_dir / "last.pt", "--data",
                tmp / "sample_2.hdf5", "--model-cfg", "unet_classic", "--data-cfg",
                "singlebubble", "--steps", STEPS, "--start-time", START, "--save-dir", out,
                "--device", "cpu", cwd=tmp)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "window 1: relative L2 = " in proc.stdout
    preds = np.load(out / "predictions.npz")["preds"]
    assert preds.shape == (STEPS, 4, 64, 64) and np.isfinite(preds).all()


@pytest.mark.parametrize("name,count", [("unet_modern", 566_747_956),
                                        ("unet_classic", 7_768_564)])
def test_full_width_configs_build_with_the_jax_parameter_counts(name, count):
    """The config's params, on torch's meta device (no memory), against the
    JAX model's count from ``jax.eval_shape``."""
    cfg = load_config([f"model_cfg={name}"])
    jax_model = jax_get_model(name, **cfg["model_cfg"]["params"], input_fields=4,
                              output_fields=4, time_window=5)
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.key(0),
                                                   jnp.zeros((1, 5, 4, 32, 32))))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"])) == count
    with torch.device("meta"):
        model = get_model(name, **cfg["model_cfg"]["params"])
        built = build_model(cfg["model_cfg"], cfg["data_cfg"], compute_dtype="bfloat16")
    assert sum(p.numel() for p in model.parameters()) == count
    assert sum(p.numel() for p in built.parameters()) == count
    assert all(p.dtype == torch.float32 for p in built.parameters())


@pytest.mark.parametrize("name,field", [("unet_classic", "hidden_chanels"),
                                        ("unet_modern", "ch_mult"),
                                        ("unet_modern", "attn_impl")])
def test_a_misspelt_or_foreign_field_raises(name, field):
    """A field the model does not have raises in both packages."""
    with pytest.raises(TypeError):
        jax_get_model(name, **{field: 4})
    with pytest.raises(TypeError):
        get_model(name, **{field: 4})
    cfg = load_config([f"model_cfg={name}", f"model_cfg.params.{field}=4"])
    with pytest.raises(TypeError):
        build_model(cfg["model_cfg"], cfg["data_cfg"])


def _module(**kw):
    return ForecastModule(TINY_CLASSIC, DATA_CFG, LION, SCHED, total_steps=8, device="cpu", **kw)


def _batches(n):
    return [synthetic_batch(2, 5, 4, 32, 32, seed=20 + i) for i in range(n)]


def test_eval_step_uses_the_running_statistics_and_nhwc_warns():
    """The eval step normalises with the running statistics and leaves them
    alone; a train step updates them; ``loss_layout="nhwc"`` warns and
    keeps the NCHW loss, as in the JAX module."""
    module = _module()
    batch = tuple(torch.from_numpy(a) for a in _batches(1)[0])
    before = {k: v.clone() for k, v in running_stats(module.model.state_dict()).items()}
    metrics, pred = module.eval_step(batch)
    with torch.no_grad():
        want = module.model.eval()(batch[0])
    torch.testing.assert_close(pred, want, rtol=0, atol=0)
    for k, v in running_stats(module.model.state_dict()).items():
        assert torch.equal(v, before[k]), k
    module.train_step(batch)
    assert all(not torch.equal(v, before[k])
               for k, v in running_stats(module.model.state_dict()).items())
    with pytest.warns(UserWarning, match="no native channels-last"):
        nhwc = _module(loss_layout="nhwc")
    assert np.isfinite(float(nhwc.train_step(batch)["loss"]))


def test_preemption_and_non_finite_checkpoints_of_a_unet_load_back(tmp_path):
    """SIGTERM while the loader yields the second batch leaves a numbered
    checkpoint that restores the step and the running statistics; a NaN
    batch stops the run with ``non_finite_state.pt``, which loads back."""
    def kill(i):
        if i == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    preempt = next_preempt_ckpt_path(str(tmp_path), None)
    trainer = Trainer(_module(), log_dir=str(tmp_path), preempt_ckpt_path=preempt)
    try:
        module = trainer.fit(ListLoader(_batches(4), on_yield=kill), max_epochs=3)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert 1 <= module.step <= 2 and os.path.exists(preempt)
    again = _module()
    restore_checkpoint(preempt, again)
    assert again.step == module.step
    for k, v in running_stats(module.model.state_dict()).items():
        torch.testing.assert_close(again.model.state_dict()[k], v, rtol=0, atol=0, msg=k)

    batches = _batches(3)
    batches[1] = (np.full_like(batches[1][0], np.nan), batches[1][1])
    crash_dir = tmp_path / "crash"
    trainer = Trainer(_module(), log_dir=str(crash_dir), log_every=1)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        trainer.fit(ListLoader(batches), max_epochs=1)
    snapshot = str(crash_dir / "non_finite_state.pt")
    assert load_checkpoint(snapshot)["step"] == 2
    crashed = _module()
    restore_checkpoint(snapshot, crashed)
    assert crashed.step == 2 and len(running_stats(crashed.model.state_dict())) == 36
