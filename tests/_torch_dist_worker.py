"""One rank of the port's data-parallel CPU tests (``tests/test_torch_distributed.py``).

Run as ``python tests/_torch_dist_worker.py <scenario> <workdir>`` with a
launcher's variables in the environment (torchrun's or SLURM's), one
process a rank; each rank writes what it saw to ``<workdir>/<scenario>_<rank>.pt``.
It imports torch and the port, never JAX: the test compares what it writes
against the JAX package and against the port in one process.

* ``bootstrap``: the world forms through ``initialize_distributed`` over
  gloo; world size, leader gating and an all-reduce of ``rank + 1``.
* ``train``: every data-parallel comparison in one world — three AdamW steps
  from the bridged JAX weights in ``<workdir>/jax_weights.pt``, three steps
  from the port's own seeded init with drop-path 0 and 0.2, ClassicUnet's
  forward and backward with global BatchNorm statistics, and a
  ``Trainer.fit`` that SIGTERM stops on rank 1 alone, then resumes from the
  leader's checkpoint.
* ``tp``: a world of four, ``mesh_cfg=dp_tp`` (data 2 x model 2):
  FiLMAViT at film_avit_tiny's widths on 32x64 frames (``mega`` + ``lane``)
  from the bridged JAX weights in ``<workdir>/jax_weights_tp.pt``, three
  AdamW steps; ClassicUnet's forward and backward with global BatchNorm
  statistics over the data group; a ``Trainer.fit`` whose leader writes a
  whole checkpoint, restored by every rank; and every rank restoring the
  one-process checkpoint ``<workdir>/single.pt``.
"""
import os
import signal
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bubbleformer_tpu_torch.data import synthetic_batch  # noqa: E402
from bubbleformer_tpu_torch.parallel import (  # noqa: E402
    batch_sharding,
    host_mean,
    initialize_distributed,
    is_leader,
    make_mesh,
)
from bubbleformer_tpu_torch.parallel.sharding import (  # noqa: E402
    gather_full_state,
    shard_state,
)
from bubbleformer_tpu_torch.training import (  # noqa: E402
    ConditionedForecastModule,
    ForecastModule,
    Trainer,
    restore_checkpoint,
)

MODEL = {"name": "filmavit", "params": {"patch_size": 4, "embed_dim": 32, "num_heads": 4,
                                        "processor_blocks": 2, "drop_path": 0.0,
                                        "num_fluid_params": 9}}
UNET = {"name": "unet_classic", "params": {"hidden_channels": 4}}
DATA = {"input_fields": ["dfun", "temperature", "velx", "vely"],
        "output_fields": ["dfun", "temperature", "velx", "vely"], "time_window": 2}
# tests/test_torch_training.py's three-step settings: AdamW's eps of 1e-3
# keeps gradients that are zero up to rounding from being scaled to lr.
ADAMW = {"name": "adamw", "params": {"lr": 1e-3, "weight_decay": 1e-2, "eps": 1e-3}}
SCHED = {"name": "cosine_warmup", "params": {"warmup_iters": 2, "eta_min": 1e-6}}
GLOBAL_BATCH = 4
STEPS = 3
FRAME = (16, 16)
DROP_PATHS = (0.0, 0.2)
# The tensor-parallel world: film_avit_tiny's widths (embed 96, 6 heads, 2
# blocks) on 32x64 frames at patch 4, an 8x16 token grid, where "auto"
# takes mega (K1) and lane (K2) as on a TPU.
MODEL_TP = {"name": "filmavit", "params": {"patch_size": 4, "embed_dim": 96, "num_heads": 6,
                                           "processor_blocks": 2, "drop_path": 0.0,
                                           "num_fluid_params": 9}}
FRAME_TP = (32, 64)
TP_DATA, TP_MODEL = 2, 2


def global_batches(n=STEPS, seed=0, frame=FRAME):
    return [synthetic_batch(GLOBAL_BATCH, DATA["time_window"], 4, *frame, num_fluid_params=9,
                            seed=seed + i) for i in range(n)]


def tp_module(**kw):
    return ConditionedForecastModule(MODEL_TP, DATA, ADAMW, SCHED, total_steps=10, device="cpu",
                                     **kw)


def step_generator(step: int) -> torch.Generator:
    return torch.Generator().manual_seed(1000 + step)


def film_module(drop_path=0.0, **kw):
    cfg = {"name": "filmavit", "params": dict(MODEL["params"], drop_path=drop_path)}
    return ConditionedForecastModule(cfg, DATA, ADAMW, SCHED, total_steps=10, device="cpu",
                                     **kw)


def unet_module(**kw):
    return ForecastModule(UNET, DATA, ADAMW, SCHED, total_steps=10, device="cpu", **kw)


def train_steps(module, batches, generators: bool):
    """``STEPS`` train steps on this process's rows of each global batch;
    returns the losses (means over the world) and the parameters."""
    rows = batch_sharding(module.mesh, GLOBAL_BATCH)
    losses = []
    for i, b in enumerate(batches):
        part = tuple(torch.from_numpy(np.ascontiguousarray(a[rows])) for a in b)
        m = module.train_step(part, step_generator(i) if generators else None)
        losses.append(host_mean(float(m["loss"])))
    return losses, {k: v.detach().clone() for k, v in module.model.state_dict().items()}


def unet_forward_backward(module, batch):
    """ClassicUnet in train mode on this process's rows: its output, every
    parameter's gradient (averaged over the world) and the running
    statistics."""
    rows = batch_sharding(module.mesh, GLOBAL_BATCH)
    inp, tgt = (torch.from_numpy(np.ascontiguousarray(a[rows])) for a in batch[:2])
    module.train_model.train()
    pred = module.train_model(inp)
    module._loss(pred, tgt).backward()
    grads = {n: p.grad.clone() for n, p in module.model.named_parameters()}
    stats = {k: v.clone() for k, v in module.model.state_dict().items() if "running" in k}
    return pred.detach(), grads, stats


class ListLoader:
    def __init__(self, batches, on_yield=None):
        self.batches, self.on_yield = batches, on_yield

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if self.on_yield is not None:
                self.on_yield(i)
            yield b


def preempted_fit(workdir: Path, rank: int):
    """SIGTERM to rank 1 alone while its loader yields the third batch (the
    loader runs one ahead of the steps): every rank stops after step 2, the
    leader writes the one preemption checkpoint, and a restore resumes from
    it."""
    log_dir = workdir / "fit"
    preempt = str(log_dir / "hpc_ckpt_1.pt")
    module = film_module(drop_path=0.1)
    rows = batch_sharding(module.mesh, GLOBAL_BATCH)
    local = [tuple(np.ascontiguousarray(a[rows]) for a in b)
             for b in global_batches(4, seed=20)]

    def kill(i):
        if rank == 1 and i == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    trainer = Trainer(module, log_dir=str(log_dir), preempt_ckpt_path=preempt, log_every=1)
    try:
        trainer.fit(ListLoader(local, on_yield=kill), max_epochs=3)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    files = sorted(p.name for p in log_dir.iterdir() if p.suffix == ".pt")
    again = film_module(drop_path=0.1)
    restore_checkpoint(preempt, again)
    restored_equal = all(torch.equal(v, module.model.state_dict()[k])
                         for k, v in again.model.state_dict().items())
    restored_step = again.step
    Trainer(again, log_dir=str(workdir / "resumed"), log_every=1).fit(ListLoader(local),
                                                                       max_epochs=2)
    return {"stopped_step": module.step, "files": files, "restored_step": restored_step,
            "restored_equal": restored_equal, "resumed_step": again.step,
            "resumed": {k: v.clone() for k, v in again.model.state_dict().items()},
            "csv_rows": (log_dir / "metrics.csv").read_text().splitlines()}


def tensor_parallel(workdir: Path, rank: int) -> dict:
    """The ``tp`` scenario's runs (module docstring); the parameters as each
    rank holds them and, gathered, whole."""
    mesh = make_mesh(model=TP_MODEL, device="cpu")
    out = {"mesh": (mesh.data, mesh.model, mesh.data_rank, mesh.model_rank)}
    module = tp_module(mesh=mesh)
    full = torch.load(workdir / "jax_weights_tp.pt")
    module.model.load_state_dict(shard_state(full, module.model_shard))
    losses, local = train_steps(module, global_batches(frame=FRAME_TP), generators=False)
    blocks = module.model.blocks
    out.update(losses=losses, local=local, ddp=type(module.train_model).__name__,
               routes=[(b.temporal._route, b.spatial._route) for b in blocks],
               whole=gather_full_state(local, module.model_shard))
    out["unet"] = unet_forward_backward(unet_module(mesh=mesh), global_batches(1, seed=30)[0])

    log_dir = workdir / "tp_fit"
    fit = tp_module(mesh=mesh)
    fit.model.load_state_dict(shard_state(full, fit.model_shard))
    rows = batch_sharding(mesh, GLOBAL_BATCH)
    local_batches = [tuple(np.ascontiguousarray(a[rows]) for a in b)
                     for b in global_batches(2, seed=40, frame=FRAME_TP)]
    Trainer(fit, log_dir=str(log_dir), log_every=1).fit(ListLoader(local_batches), max_epochs=1)
    again = tp_module(mesh=mesh)
    restore_checkpoint(str(log_dir / "last.pt"), again)
    out["fit_local"] = {k: v.clone() for k, v in fit.model.state_dict().items()}
    out["restored_equal"] = all(torch.equal(v, out["fit_local"][k])
                                for k, v in again.model.state_dict().items())
    out["restored_moments_equal"] = all(
        torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
        for a, b in zip(again.optimizer.state_dict()["state"].values(),
                        fit.optimizer.state_dict()["state"].values()))
    single = tp_module(mesh=mesh)
    restore_checkpoint(str(workdir / "single.pt"), single)
    out["from_single"] = {k: v.clone() for k, v in single.model.state_dict().items()}
    out["from_single_step"] = single.step
    return out


def main():
    scenario, workdir = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    env = initialize_distributed(device="cpu")
    rank = env.rank
    out = {"rank": rank, "launcher": env.launcher}
    if scenario == "bootstrap":
        t = torch.tensor([rank + 1.0])
        torch.distributed.all_reduce(t)
        mesh = make_mesh(device="cpu")
        out.update(world=torch.distributed.get_world_size(), leader=is_leader(),
                   sum=float(t[0]), backend=mesh.backend, mesh_data=mesh.data,
                   rows=batch_sharding(mesh, GLOBAL_BATCH))
    elif scenario == "train":
        module = film_module()
        module.model.load_state_dict(torch.load(workdir / "jax_weights.pt"))
        out["jax"] = train_steps(module, global_batches(), generators=False)
        out["ddp"] = type(module.train_model).__name__
        for rate in DROP_PATHS:
            out[f"own {rate}"] = train_steps(film_module(drop_path=rate), global_batches(seed=7),
                                             generators=True)
        out["unet"] = unet_forward_backward(unet_module(), global_batches(1, seed=30)[0])
        out["fit"] = preempted_fit(workdir, rank)
    elif scenario == "tp":
        out.update(tensor_parallel(workdir, rank))
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    torch.save(out, workdir / f"{scenario}_{rank}.pt")
    print(f"rank {rank} {scenario} OK", flush=True)


if __name__ == "__main__":
    main()
