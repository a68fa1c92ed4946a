"""Process-group bootstrap, leader gating and the data-parallel mesh.

Counterpart of ``bubbleformer_tpu/parallel/mesh.py``.  The reference trains
across GPUs with Lightning's DDP over NCCL; the JAX package with a ``data``
mesh axis whose gradient sums XLA inserts.  The port runs the reference's
strategy by hand: one process a GPU, each building the model from the same
seed, reading its own strided shard of every epoch's permutation
(``data/pipeline.py``) and wrapping the model in
``DistributedDataParallel`` (``training/module.py``), whose all-reduce
averages the gradients, so that a step equals one process's step on the
global batch: the concatenation of the ranks' batches in rank order.

* :func:`initialize_distributed` reads the launcher's environment —
  ``torchrun``'s ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
  and ``MASTER_PORT``, or SLURM's ``SLURM_PROCID``, ``SLURM_NTASKS``,
  ``SLURM_LOCALID`` and ``SLURM_STEP_NODELIST`` — and joins the process
  group: NCCL on the card, gloo where the caller asks for the CPU or for
  gloo by name.  One process does nothing; a world of more than one never
  becomes a one-process run, and a misconfigured one raises.
* :func:`is_leader` gates logging and checkpoint writes.
* :func:`make_mesh` checks a ``mesh_cfg`` against the world: the ``data``
  axis must span it; ``model`` (tensor parallelism) and ``spatial``
  (spatial parallelism) axes are not ported and raise.
* :func:`batch_sharding` is the rank's rows of a global batch.  The
  parameters need no counterpart of ``replicated``: DDP broadcasts the
  leader's when it wraps the model, and equal gradients keep them equal.

Host-side agreements (the logged loss, the SIGTERM flag, barriers around a
checkpoint) run over gloo on CPU tensors (:func:`host_group`), so that they
never wait on the card's stream.
"""
from __future__ import annotations

import functools
import os
import re
from dataclasses import dataclass
from typing import Mapping, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class LaunchEnv:
    """One process's place in the world, as its launcher states it."""

    rank: int
    world_size: int
    local_rank: int
    master_addr: Optional[str]
    master_port: Optional[int]
    launcher: str


def _first_host(nodelist: str) -> str:
    """The first host of a SLURM node list (``node[03-05,7],gpu2`` ->
    ``node03``)."""
    m = re.match(r"([^,\[]+)(?:\[([^\]]+)\])?", nodelist.strip())
    if m is None:
        raise ValueError(f"cannot read SLURM_STEP_NODELIST={nodelist!r}")
    prefix, ranges = m.groups()
    return prefix if ranges is None else prefix + ranges.split(",")[0].split("-")[0]


def launch_env(env: Optional[Mapping[str, str]] = None) -> LaunchEnv:
    """The launcher's statement of this process's rank and world:
    ``torchrun``'s variables where ``WORLD_SIZE`` is set, else SLURM's where
    ``SLURM_NTASKS`` is (the port as ``mesh.py:45-53`` reads the launchers;
    SLURM's port is ``MASTER_PORT``, else 15000 plus the job id's last four
    digits, as Lightning picks it), else one process."""
    env = os.environ if env is None else env
    if "WORLD_SIZE" in env:
        port = env.get("MASTER_PORT")
        return LaunchEnv(int(env.get("RANK", "0")), int(env["WORLD_SIZE"]),
                         int(env.get("LOCAL_RANK", env.get("RANK", "0"))),
                         env.get("MASTER_ADDR"), int(port) if port else None, "torchrun")
    if "SLURM_NTASKS" in env:
        port = env.get("MASTER_PORT")
        if not port and env.get("SLURM_JOB_ID"):
            port = str(15000 + int(env["SLURM_JOB_ID"][-4:]))
        nodes = env.get("SLURM_STEP_NODELIST") or env.get("SLURM_NODELIST")
        return LaunchEnv(int(env.get("SLURM_PROCID", "0")), int(env["SLURM_NTASKS"]),
                         int(env.get("SLURM_LOCALID", "0")),
                         env.get("MASTER_ADDR") or (_first_host(nodes) if nodes else None),
                         int(port) if port else None, "slurm")
    return LaunchEnv(0, 1, 0, None, None, "none")


def initialize_distributed(backend: Optional[str] = None, device: Optional[str] = None,
                           env: Optional[Mapping[str, str]] = None) -> LaunchEnv:
    """Join the launcher's process group (nothing for one process).

    ``backend``: ``"nccl"`` (the default) or ``"gloo"``; ``device="cpu"``
    picks gloo.  Under NCCL the process takes the card ``LOCAL_RANK`` (set
    before the group forms, as NCCL wants); no card raises.  Returns the
    launch environment."""
    le = launch_env(env)
    if dist.is_initialized():
        return le
    if le.world_size < 1 or not 0 <= le.rank < le.world_size or le.local_rank < 0:
        raise ValueError(f"{le.launcher}: rank {le.rank} of world {le.world_size} "
                         f"(local rank {le.local_rank}) is not a place in a world")
    if le.world_size == 1:
        return le
    if not le.master_addr or not le.master_port:
        raise ValueError(f"{le.launcher}: a world of {le.world_size} processes needs "
                         "MASTER_ADDR and MASTER_PORT (or SLURM's node list and job id)")
    if backend is None:
        backend = "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA card; ask for the CPU "
                               "(device=cpu, the gloo backend) to run without one")
        if le.local_rank >= torch.cuda.device_count():
            raise ValueError(f"local rank {le.local_rank} has no card: "
                             f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(le.local_rank)
    dist.init_process_group(backend, init_method=f"tcp://{le.master_addr}:{le.master_port}",
                            world_size=le.world_size, rank=le.rank)
    # Every rank here before any work, as Lightning's rendezvous has it.
    dist.barrier(group=host_group())
    return le


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_leader() -> bool:
    """Leader gating for logging and checkpoint side effects."""
    return process_index() == 0


@functools.lru_cache(maxsize=None)
def _gloo_group(world_id: int):
    return dist.new_group(backend="gloo")


def host_group():
    """A group for collectives on CPU tensors: the default group under gloo,
    a gloo group beside NCCL's (made once a world, by every rank together)."""
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    return _gloo_group(id(dist.group.WORLD))


def host_barrier() -> None:
    """Every rank waits for the others (nothing for one process)."""
    if process_count() > 1:
        dist.barrier(group=host_group())


def host_mean(value: float) -> float:
    """The mean of ``value`` over the ranks (``value`` for one process)."""
    if process_count() == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64)
    dist.all_reduce(t, group=host_group())
    return float(t[0]) / process_count()


def host_any(flag: bool) -> bool:
    """True where any rank's ``flag`` is (``flag`` for one process)."""
    if process_count() == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
    return bool(t[0])


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, whose backward sums the gradients the same
    way: the gradient of every rank's loss reaches every rank's input."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out)
        return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably (the default group)."""
    return _AllReduceSum.apply(x)


@dataclass(frozen=True)
class Mesh:
    """The run's mesh: ``data`` processes (the world), each on ``device``."""

    data: int
    model: int
    spatial: int
    rank: int
    device: torch.device
    backend: Optional[str]


def make_mesh(data: int = -1, model: int = 1, spatial: int = 1,
              device: str = "cuda") -> Mesh:
    """The data-parallel mesh over the world (``data=-1``: all of it).

    ``model > 1`` and ``spatial > 1`` raise ``ValueError`` naming
    ``mesh_cfg``: tensor and spatial parallelism are not ported.  ``data``
    must equal the number of processes (``mesh.py:99-105``).  ``device``
    ``"cuda"`` is the card ``LOCAL_RANK`` in a world of processes."""
    if model != 1:
        raise ValueError(f"mesh_cfg: model={model} asks for tensor parallelism, which the "
                         "port does not have yet; mesh_cfg=single (data parallelism) runs")
    if spatial != 1:
        raise ValueError(f"mesh_cfg: spatial={spatial} asks for spatial parallelism, which "
                         "the port does not have yet; mesh_cfg=single (data parallelism) runs")
    n = process_count()
    if data == -1:
        data = n
    if data != n:
        raise ValueError(f"mesh_cfg: mesh {data}x{model}x{spatial} != {n} processes")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", launch_env().local_rank)
    return Mesh(data, model, spatial, process_index(), dev,
                dist.get_backend() if dist.is_initialized() else None)


def batch_sharding(mesh: Mesh, global_batch: int) -> slice:
    """The rows of a global batch of ``global_batch`` that ``mesh``'s rank
    holds: the ``rank``-th of ``mesh.data`` equal runs."""
    if global_batch % mesh.data:
        raise ValueError(f"a global batch of {global_batch} does not split over "
                         f"{mesh.data} processes")
    local = global_batch // mesh.data
    return slice(mesh.rank * local, (mesh.rank + 1) * local)
