"""Device meshes, the params' layout over them, data parallelism and the
multi-device dry run (``norma_tpu/parallel``)."""

from .sharding import (
    Mesh,
    ShardedBatch,
    ShardedParams,
    batch_sharding,
    make_mesh,
    param_shardings,
    shard_batch,
    shard_params,
)

__all__ = [
    "Mesh",
    "ShardedBatch",
    "ShardedParams",
    "batch_sharding",
    "make_mesh",
    "param_shardings",
    "shard_batch",
    "shard_params",
]
