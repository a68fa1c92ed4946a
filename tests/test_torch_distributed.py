"""The port's data parallelism on the CPU: real two-process worlds over gloo.

The ranks run ``tests/_torch_dist_worker.py`` (torch and the port, no JAX)
under torchrun's or SLURM's variables; one world runs every training
comparison, so that the file pays for a world's start-up twice in all.
Against them:

* the JAX package's single-device train step at the global batch (3 AdamW
  steps from the same bridged weights), with the tolerances of
  ``tests/test_torch_training.py``'s three-step test (losses rtol 1e-5,
  parameters rtol 1e-5 / atol 2e-6);
* the port's own one-process run at the global batch, from its seeded init,
  drop-path off and on, with ``tests/test_distributed.py:87-96``'s (losses
  rtol 2e-4 / atol 1e-5, parameters 2e-5);
* ClassicUnet in one process: outputs, gradients and BatchNorm running
  statistics, normalised over the global batch;
* a SIGTERM to one rank: every rank stops at the same step.

Plus the launchers' variables, the shards of the JAX loader, the mesh's
refusals and the build lock, which need no world.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.data.pipeline import DataLoader as JaxDataLoader
from bubbleformer_tpu.training import ConditionedForecastModule as JaxConditionedModule
from bubbleformer_tpu_torch.data import DataLoader, SyntheticLoader, native
from bubbleformer_tpu_torch.parallel import (
    batch_sharding,
    initialize_distributed,
    launch_env,
    make_mesh,
)
from bubbleformer_tpu_torch.utils.convert import jax_params_to_state_dict
from tests._torch_dist_worker import (
    ADAMW,
    DATA,
    DROP_PATHS,
    MODEL,
    SCHED,
    film_module,
    global_batches,
    train_steps,
    unet_forward_backward,
    unet_module,
)
from tests.test_torch_model import randomize

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_dist_worker.py"
LAUNCHERS = ("torchrun", "slurm")
PROCESSES = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(scenario: str, workdir: Path, launcher: str = "torchrun", timeout: float = 240):
    """Run the worker's ``scenario`` on a world of two processes under
    ``launcher``'s variables; returns each rank's record."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("SLURM") and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                                        "MASTER_ADDR", "MASTER_PORT")}
    base.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = []
    for rank in range(PROCESSES):
        if launcher == "torchrun":
            env = dict(base, RANK=str(rank), WORLD_SIZE=str(PROCESSES), LOCAL_RANK=str(rank),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        else:
            env = dict(base, SLURM_NTASKS=str(PROCESSES), SLURM_PROCID=str(rank),
                       SLURM_LOCALID=str(rank), SLURM_STEP_NODELIST="localhost",
                       SLURM_JOB_ID="4242", MASTER_PORT=port)
        procs.append(subprocess.Popen([sys.executable, str(WORKER), scenario, str(workdir)],
                                      env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:  # a rank that hangs in a collective is stopped
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {rank} {scenario} OK" in out, out
    return [torch.load(workdir / f"{scenario}_{rank}.pt", weights_only=False)
            for rank in range(PROCESSES)]


@pytest.mark.parametrize("launcher", LAUNCHERS)
def test_two_process_bootstrap(launcher, tmp_path):
    """The world forms from each launcher's variables: two processes, the
    leader rank 0 alone, an all-reduce of rank + 1 giving 3.0, and each
    rank holding its half of a global batch."""
    ranks = _launch("bootstrap", tmp_path, launcher)
    for rank, out in enumerate(ranks):
        assert out["launcher"] == launcher and out["rank"] == rank
        assert out["world"] == out["mesh_data"] == PROCESSES and out["backend"] == "gloo"
        assert out["leader"] == (rank == 0)
        assert out["sum"] == 3.0
        assert out["rows"] == slice(2 * rank, 2 * rank + 2)


@pytest.mark.parametrize("env,want", [
    ({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "h0",
      "MASTER_PORT": "29500"}, (3, 4, 1, "h0", 29500, "torchrun")),
    ({"SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_LOCALID": "1",
      "SLURM_STEP_NODELIST": "gpu[03-05,7],cpu2", "SLURM_JOB_ID": "123456"},
     (5, 8, 1, "gpu03", 15000 + 3456, "slurm")),
    ({"SLURM_NTASKS": "2", "SLURM_PROCID": "0", "SLURM_STEP_NODELIST": "node1",
      "MASTER_PORT": "1234"}, (0, 2, 0, "node1", 1234, "slurm")),
    ({}, (0, 1, 0, None, None, "none")),
])
def test_launch_env_reads_the_launchers(env, want):
    le = launch_env(env)
    assert (le.rank, le.world_size, le.local_rank, le.master_addr, le.master_port,
            le.launcher) == want


@pytest.mark.parametrize("env,error,match", [
    ({"WORLD_SIZE": "2", "RANK": "1"}, ValueError, "MASTER_ADDR"),
    ({"WORLD_SIZE": "2", "RANK": "2", "MASTER_ADDR": "h", "MASTER_PORT": "1"}, ValueError,
     "not a place"),
    ({"WORLD_SIZE": "2", "RANK": "0", "MASTER_ADDR": "h", "MASTER_PORT": "1"},
     RuntimeError, "nccl backend needs a CUDA card"),
])
def test_a_misconfigured_world_raises(env, error, match):
    """A world of two never falls back to one process: a world without its
    rendezvous, a rank outside it, or NCCL without a card raises before
    any group forms."""
    if torch.cuda.is_available() and error is RuntimeError:
        pytest.skip("a card is present: NCCL would start")
    with pytest.raises(error, match=match):
        initialize_distributed(env=env)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("kw", [{"model": 2}, {"spatial": 2}, {"data": 3}])
def test_mesh_refuses_what_is_not_ported(kw):
    with pytest.raises(ValueError, match="mesh_cfg"):
        make_mesh(device="cpu", **kw)
    mesh = make_mesh(device="cpu")
    assert (mesh.data, mesh.rank, mesh.backend) == (1, 0, None)
    assert batch_sharding(mesh, 4) == slice(0, 4)


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n,count,seed,epoch", [(10, 1, 0, 0), (10, 2, 0, 3), (11, 2, 5, 1),
                                                (17, 4, 42, 2), (8, 3, 1, 0)])
def test_shards_equal_the_jax_loaders(n, count, seed, epoch):
    """Each process's shard of an epoch is the JAX loader's, the shards are
    disjoint and of one length (``n // count``), and each is its own
    ``batch_size`` batches."""
    shards = []
    for index in range(count):
        kw = dict(batch_size=2, shuffle=True, seed=seed, process_index=index,
                  process_count=count)
        port, ref = DataLoader(_Sized(n), **kw), JaxDataLoader(_Sized(n), **kw)
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        np.testing.assert_array_equal(port._local_indices(), ref._local_indices())
        assert len(port) == len(ref)
        shards.append(set(port._local_indices().tolist()))
    assert len(set().union(*shards)) == sum(map(len, shards))
    assert len({len(s) for s in shards}) == 1


def test_synthetic_loader_shards_the_global_batch():
    whole = SyntheticLoader(2, 4, 2, 4, 16, 9, seed=3)
    parts = [SyntheticLoader(2, 2, 2, 4, 16, 9, seed=3, process_index=r, process_count=2)
             for r in range(2)]
    for i, batch in enumerate(whole):
        for k, a in enumerate(batch):
            np.testing.assert_array_equal(a, np.concatenate([p.batches[i][k] for p in parts]))


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    """The JAX package's three steps at the global batch (in this process),
    then the world's ``train`` scenario from the same bridged weights."""
    workdir = tmp_path_factory.mktemp("dp_train")
    batches = global_batches()
    ref = JaxConditionedModule(MODEL, DATA, ADAMW, SCHED, total_steps=10)
    state = ref.init_state(jax.random.key(0), batches[0])
    params = randomize({"params": state.params}, 4)["params"]
    state = state.replace(params=params, opt_state=ref.optimizer.init(params))
    torch.save(jax_params_to_state_dict({"params": params}), workdir / "jax_weights.pt")
    step = jax.jit(ref.make_train_step())
    losses = []
    for b in batches:
        state, m = step(state, tuple(jnp.asarray(a) for a in b), jax.random.key(1))
        losses.append(float(m["loss"]))
    final = jax_params_to_state_dict({"params": jax.tree.map(np.asarray, state.params)})
    return _launch("train", workdir), (losses, final)


def test_dp_matches_jax(train_world):
    """Two ranks at batch 2 against the JAX package's one device at batch 4,
    three AdamW steps from the same weights: DDP's average of the ranks'
    gradients is the global batch's gradient."""
    ranks, (want_losses, want) = train_world
    assert ranks[0]["ddp"] == "DistributedDataParallel"
    losses, got = ranks[0]["jax"]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("rate", DROP_PATHS)
def test_dp_matches_one_process(train_world, rate):
    """Two ranks against the port's one process at the global batch, from
    the seeded init; with drop-path on, each rank takes its rows of the
    global batch's masks, so the same samples are dropped."""
    ranks, _ = train_world
    losses, got = ranks[0][f"own {rate}"]
    want_losses, want = train_steps(film_module(drop_path=rate), global_batches(seed=7),
                                    generators=True)
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4, atol=1e-5)
    assert max(float((v - want[k]).abs().max()) for k, v in got.items()) < 2e-5
    moved = film_module(drop_path=rate).model.state_dict()
    assert all(not torch.equal(v, moved[k]) for k, v in got.items() if "weight" in k)


def test_dp_ranks_hold_equal_parameters(train_world):
    ranks, _ = train_world
    for key in ("jax",) + tuple(f"own {r}" for r in DROP_PATHS):
        (l0, p0), (l1, p1) = ranks[0][key], ranks[1][key]
        assert l0 == l1
        for k, v in p0.items():
            assert torch.equal(v, p1[k]), (key, k)


def test_classic_unet_global_batch_norm(train_world):
    """ClassicUnet in train mode on two ranks normalises with the global
    batch's statistics: each rank's output is its rows of the one-process
    output, the averaged gradients are the one process's, and the running
    statistics (biased variance, the flax rule) are the same on both ranks
    and the one process's.  Float32 sums in other orders: outputs 1e-5 of
    their largest, gradients 1e-4 of each one's largest, statistics 1e-6."""
    ranks, _ = train_world
    ref = unet_module()
    want_pred, want_grads, want_stats = unet_forward_backward(ref, global_batches(1, seed=30)[0])
    scale = float(want_pred.abs().max())
    for rank, out in enumerate(ranks):
        pred, grads, stats = out["unet"]
        rows = slice(2 * rank, 2 * rank + 2)
        assert float((pred - want_pred[rows]).abs().max()) <= 1e-5 * scale
        for n, g in grads.items():
            assert float((g - want_grads[n]).abs().max()) <= 1e-4 * float(
                want_grads[n].abs().max()), n
            assert torch.equal(g, ranks[0]["unet"][1][n]), n
        for k, v in stats.items():
            torch.testing.assert_close(v, want_stats[k], rtol=1e-6, atol=1e-6)
            assert torch.equal(v, ranks[0]["unet"][2][k]), k
    assert set(stats) and any(not torch.equal(v, torch.zeros_like(v)) for v in stats.values())


def test_sigterm_on_one_rank_stops_every_rank(train_world):
    """SIGTERM to rank 1 alone: both ranks stop at the same step boundary,
    the leader writes the one preemption checkpoint and the only metrics
    rows, every rank restores the stopped state from it, and the resumed
    runs end equal on both ranks."""
    ranks, _ = train_world
    f0, f1 = ranks[0]["fit"], ranks[1]["fit"]
    assert f0["stopped_step"] == f1["stopped_step"] == 2
    assert f0["files"] == f1["files"] == ["hpc_ckpt_1.pt"]
    assert f0["restored_step"] == f1["restored_step"] == f0["stopped_step"]
    assert f0["restored_equal"] and f1["restored_equal"]
    rows = f0["csv_rows"]
    assert rows[0] == "step,epoch,split,loss,learning_rate"
    assert len(rows) == 2  # the header and the leader's row of step 1 alone
    assert f0["resumed_step"] == f1["resumed_step"] > f0["stopped_step"]
    for k, v in f0["resumed"].items():
        assert torch.equal(v, f1["resumed"][k]), k


_BUILD = """
import sys
from pathlib import Path
from bubbleformer_tpu_torch.data import native
native.BUILD_DIR = Path(sys.argv[1])
compile_ = native._compile
def counted(so):
    print("compiled", flush=True)
    compile_(so)
native._compile = counted
print("available", native.available(), native.library_path().name, flush=True)
"""


def test_concurrent_native_builds_compile_once(tmp_path):
    """Two processes that build the batch assembler at once: one compiles
    under the lock, the other waits and loads the same library."""
    if native.unavailable_reason() is not None:
        pytest.skip(f"no C compiler here: {native.unavailable_reason()}")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert sum(out.count("compiled") for out in outs) == 1, outs
    name = native.library_path().name
    assert all(f"available True {name}" in out for out in outs), outs
    assert sorted(p.name for p in tmp_path.iterdir()) == [name, f"{name}.lock"]


def test_world_of_one_stays_one_process(monkeypatch):
    """No launcher's variables (or a world of one): no group forms."""
    for k in ("WORLD_SIZE", "RANK", "SLURM_NTASKS"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed(device="cpu").world_size == 1
    assert initialize_distributed(env={"WORLD_SIZE": "1"}).world_size == 1
    assert not torch.distributed.is_initialized()
