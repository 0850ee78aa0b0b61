"""Parallel execution: batched solves, batch sharding over devices and
processes, and the time-sharded Riccati recursion."""

from .batch import BatchStats, batch_stats, make_batched_solve_fn
from .horizon import (
    make_horizon_sharded_backward,
    make_long_horizon_solve_fn,
    time_sharding,
)
from .shard import (
    Mesh,
    default_mesh,
    distributed_initialize,
    global_batch_from_local,
    make_sharded_solve_fn,
    shard_batch,
)

__all__ = [
    "BatchStats",
    "batch_stats",
    "make_batched_solve_fn",
    "make_horizon_sharded_backward",
    "make_long_horizon_solve_fn",
    "time_sharding",
    "Mesh",
    "default_mesh",
    "distributed_initialize",
    "global_batch_from_local",
    "make_sharded_solve_fn",
    "shard_batch",
]
