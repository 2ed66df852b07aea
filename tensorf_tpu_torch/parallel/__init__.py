"""Ray-batch data parallelism (counterpart of tensorf_tpu/parallel)."""

from .launch import RankFailed, join_from_env, rank_devices, spawn
from .mesh import (
    RankGroup,
    allreduce_grads,
    broadcast_params,
    gather_rows,
    host_allmax,
    host_allsum,
    host_ray_pool,
    pad_to_multiple,
    shard_rows,
)
