"""Data parallelism across processes (``mesh.py``); tensor and spatial
parallelism (the JAX package's ``parallel/sharding.py``) are not ported."""
from bubbleformer_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    host_any,
    host_barrier,
    host_mean,
    initialize_distributed,
    is_leader,
    launch_env,
    make_mesh,
)

__all__ = [
    "Mesh",
    "batch_sharding",
    "host_any",
    "host_barrier",
    "host_mean",
    "initialize_distributed",
    "is_leader",
    "launch_env",
    "make_mesh",
]
