"""The trainer's W&B logging, validation panels, profiler window and
``transfer_dtype`` against the JAX trainer's (``bubbleformer_tpu/training/
trainer.py:110-132,156,245-275,325-332``).

A tiny AViT (patch 4, C=16, 2 heads, one block, drop-path 0) trains on
16x16 frames of the four BubbleML fields.  The JAX trainer is built over a
2-device mesh and run through its own ``_put_batch`` and train step; its
weights are drawn from a seed over the parameter tree's shapes and cross to
the port through the bridge.  Losses are held to 1e-5 relative (float32, as
``tests/test_torch_training.py`` holds them).
"""
import importlib.util
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bubbleformer_tpu.training import ForecastModule as JaxForecastModule
from bubbleformer_tpu.training import Trainer as JaxTrainer
from bubbleformer_tpu.training.module import TrainState
from bubbleformer_tpu_torch.data import synthetic_batch
from bubbleformer_tpu_torch.training import ForecastModule, Trainer
from bubbleformer_tpu_torch.utils.convert import jax_params_to_state_dict
from tests.test_torch_model import randomize
from tests.test_torch_training import ADAMW, DATA_CFG, SCHED, ListLoader
from tests.test_training import small_mesh

MODEL = {"name": "avit", "params": dict(patch_size=4, embed_dim=16, num_heads=2,
                                        processor_blocks=1, drop_path=0.0)}
# The panels the JAX trainer writes for the dfun, temperature and velocity fields.
PANELS = ["pred_sdf", "pred_temp", "pred_vel", "target_sdf", "target_temp", "target_vel"]


def _batches(n, seed=20):
    return [synthetic_batch(2, 2, 4, 16, 16, seed=seed + i) for i in range(n)]


def _port_trainer(log_dir, compute_dtype=None, **kw):
    module = ForecastModule(MODEL, DATA_CFG, ADAMW, SCHED, total_steps=8, device="cpu",
                            compute_dtype=compute_dtype)
    return Trainer(module, log_dir=str(log_dir), log_every=1, limit_val_batches=1, **kw)


def _jax_trainer(log_dir, compute_dtype=None, **kw):
    cfg = {"name": "avit", "params": dict(MODEL["params"], attn_impl="plain", remat=False)}
    module = JaxForecastModule(cfg, DATA_CFG, ADAMW, SCHED, total_steps=8,
                               compute_dtype=compute_dtype)
    return JaxTrainer(module, log_dir=str(log_dir), mesh=small_mesh(2), async_checkpoint=False,
                      **kw)


class StubWandb(types.ModuleType):
    """A ``wandb`` module that records ``init``'s arguments and every
    ``log``."""

    def __init__(self):
        super().__init__("wandb")
        self.inits, self.logs = [], []

    def init(self, **kw):
        self.inits.append(kw)

    def login(self, key):
        raise AssertionError("no key file is expected")

    def log(self, row):
        self.logs.append(row)

    def Image(self, fig, caption):
        return ("image", caption)


def test_without_wandb_the_run_logs_its_csv_and_one_line(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises
    _jax_trainer(tmp_path / "jax", use_wandb=True)
    want = capsys.readouterr().out.splitlines()
    trainer = _port_trainer(tmp_path / "port", use_wandb=True)
    got = capsys.readouterr().out.splitlines()
    assert got == want and len(got) == 1 and got[0].startswith("wandb unavailable")
    assert trainer.wandb is None
    trainer.fit(ListLoader(_batches(2)), ListLoader(_batches(1, seed=30)))
    rows = (tmp_path / "port" / "metrics.csv").read_text().splitlines()
    assert rows[0] == "step,epoch,split,loss,learning_rate" and len(rows) == 4
    assert "wandb" not in capsys.readouterr().out


def test_stub_wandb_gets_the_jax_trainers_calls(tmp_path, monkeypatch):
    """``wandb.init`` gets the JAX trainer's arguments for the same log
    directory; the train losses and learning rates logged are the CSV's,
    then the epoch time, the validation loss and time, and with
    ``plot_val_samples`` the six panels as images."""
    stub = StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    log_dir = tmp_path / "run"
    _jax_trainer(log_dir, use_wandb=True)
    trainer = _port_trainer(log_dir, use_wandb=True, plot_val_samples=True)
    assert trainer.wandb is stub and len(stub.inits) == 2
    assert stub.inits[1] == stub.inits[0] == dict(project="bubbleformer_tpu", name="run",
                                                  dir=str(log_dir), resume="auto")
    trainer.fit(ListLoader(_batches(2)), ListLoader(_batches(1, seed=30)))
    rows = [r.split(",") for r in (log_dir / "metrics.csv").read_text().splitlines()[1:]]
    train = [{"train_loss": float(r[3]), "learning_rate": float(r[4])} for r in rows[:2]]
    assert stub.logs[:2] == train
    assert set(stub.logs[2]) == {"train_epoch_time", "epoch"} and stub.logs[2]["epoch"] == 0
    images = stub.logs[3:-1]
    assert sorted(k for row in images for k in row) == PANELS
    assert all(v == ("image", "Epc 0") for row in images for v in row.values())
    assert stub.logs[-1]["val_loss"] == float(rows[2][3])
    assert set(stub.logs[-1]) == {"val_loss", "val_epoch_time", "epoch"}


def test_plot_val_samples_writes_the_jax_trainers_panels(tmp_path):
    batch = _batches(1, seed=30)[0]
    pred = np.random.default_rng(3).standard_normal(batch[1].shape).astype(np.float32)
    _jax_trainer(tmp_path / "jax", plot_val_samples=True)._log_val_images((batch, pred), 0)
    want = sorted(p.name for p in (tmp_path / "jax" / "val_epoch_0").iterdir())
    assert want == [f"{name}.png" for name in PANELS]

    trainer = _port_trainer(tmp_path / "port", plot_val_samples=True)
    trainer.fit(ListLoader(_batches(1)), ListLoader(_batches(1, seed=30)))
    assert sorted(p.name for p in (tmp_path / "port" / "val_epoch_0").iterdir()) == want
    off = _port_trainer(tmp_path / "off")
    off.fit(ListLoader(_batches(1)), ListLoader(_batches(1, seed=30)))
    assert not list((tmp_path / "off").glob("val_epoch_*"))


def test_profile_window_traces_exactly_its_steps(tmp_path, capsys):
    """``profile_steps=(1, 3)`` over 5 steps: the trace holds the ranges of
    global steps 1 and 2, as the JAX trainer's window starts before step 1
    and stops after step 2."""
    trainer = _port_trainer(tmp_path / "run", profile_dir=str(tmp_path / "prof"),
                            profile_steps=(1, 3))
    trainer.fit(ListLoader(_batches(5)))
    traces = list((tmp_path / "prof").iterdir())
    assert [p.name for p in traces] == ["train_steps_1-3.pt.trace.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    steps = sorted({e["name"] for e in events if e.get("name", "").startswith("train_step ")})
    assert steps == ["train_step 1", "train_step 2"]
    assert any("addmm" in e.get("name", "") for e in events)  # the steps' own operators
    assert str(traces[0]) in capsys.readouterr().out


def test_transfer_dtype_gives_the_jax_trainers_losses(tmp_path):
    """``transfer_dtype="bfloat16"``: the first three losses equal the JAX
    trainer's on the same batches and weights (rtol 1e-5), and differ from
    the run without it (the inputs and targets are rounded to bfloat16 on
    both sides).  Both models compute in ``compute_dtype="float32"``: with
    none, each package's layers compute in their input's dtype (``dtype or
    x.dtype``, in both), so a bfloat16 batch would run them in bfloat16 and
    the comparison would hold bfloat16 rounding, not the transfer."""
    batches = _batches(3)
    jt = _jax_trainer(tmp_path / "jax", compute_dtype="float32", transfer_dtype="bfloat16")
    b0 = tuple(jnp.asarray(a) for a in batches[0])
    params = randomize(jax.eval_shape(jt.module.model.init, jax.random.key(0), b0[0]),
                       5)["params"]
    weights = jax_params_to_state_dict({"params": params})  # the train step donates params
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=jt.module.optimizer.init(params))
    want = []
    for b in batches:
        state, m = jt._train_step(state, jt._put_batch(b), jax.random.key(1))
        want.append(float(m["loss"]))

    losses = {}
    for dtype in ("bfloat16", None):
        trainer = _port_trainer(tmp_path / str(dtype), compute_dtype="float32",
                                transfer_dtype=dtype)
        trainer.module.model.load_state_dict(weights)
        trainer.fit(ListLoader(batches))
        rows = (tmp_path / str(dtype) / "metrics.csv").read_text().splitlines()[1:]
        losses[dtype] = [float(r.split(",")[3]) for r in rows]
    np.testing.assert_allclose(losses["bfloat16"], want, rtol=1e-5)
    assert not np.allclose(losses[None], want, rtol=1e-5, atol=0)
    rounded = _port_trainer(tmp_path / "put", transfer_dtype="bfloat16")._put_batch(batches[0])
    assert all(str(t.dtype) == "torch.bfloat16" for t in rounded)
    np.testing.assert_array_equal(rounded[1].float().numpy(),
                                  batches[0][1].astype(jnp.bfloat16).astype(np.float32))


@pytest.mark.parametrize("use_wandb,plot,want", [(False, None, False), (True, None, True),
                                                 (True, False, False), (False, True, True)])
def test_cli_passes_the_options(tmp_path, monkeypatch, use_wandb, plot, want):
    """``scripts/train_torch.py`` hands ``use_wandb``, ``plot_val_samples``
    (null: follow ``use_wandb``), ``profile_dir`` and ``transfer_dtype`` to the
    trainer, as ``scripts/train.py:146-164`` does."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "train_torch.py"
    spec = importlib.util.spec_from_file_location("train_torch", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    seen = {}

    class Recorder(Trainer):
        def __init__(self, module, **kw):
            seen.update(kw)
            raise SystemExit(0)

    monkeypatch.setattr(script, "Trainer", Recorder)
    argv = ["device=cpu", "model_cfg=avit_tiny", "synthetic_batches=1", "batch_size=1",
            f"log_dir={tmp_path}", f"use_wandb={str(use_wandb).lower()}",
            "profile_dir=" + str(tmp_path / "p"), "transfer_dtype=bfloat16"]
    if plot is not None:
        argv.append(f"plot_val_samples={str(plot).lower()}")
    with pytest.raises(SystemExit):
        script.main(argv)
    assert seen["use_wandb"] is use_wandb and seen["plot_val_samples"] is want
    assert seen["profile_dir"] == str(tmp_path / "p") and seen["transfer_dtype"] == "bfloat16"
