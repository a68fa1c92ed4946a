"""Data parallelism across processes and the (data, model) mesh
(``mesh.py``); tensor parallelism over the model axis (``sharding.py``, the
JAX package's ``parallel/sharding.py``).  Spatial parallelism is not
ported."""
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
from bubbleformer_tpu_torch.parallel.sharding import (
    COLUMN_PARALLEL,
    ROW_PARALLEL,
    ModelShard,
    copy_to_model,
    model_shard,
    reduce_from_model,
    shard_model,
)

__all__ = [
    "COLUMN_PARALLEL",
    "Mesh",
    "ModelShard",
    "ROW_PARALLEL",
    "batch_sharding",
    "copy_to_model",
    "host_any",
    "host_barrier",
    "host_mean",
    "initialize_distributed",
    "is_leader",
    "launch_env",
    "make_mesh",
    "model_shard",
    "reduce_from_model",
    "shard_model",
]
