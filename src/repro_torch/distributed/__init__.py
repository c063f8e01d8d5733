"""Distributed subsystem: role plans and the sharded search.

``sharding`` -- ``ShardPlan`` role-to-axis resolution, the per-shard
                locals, the mesh collective and the host entries
                (corpus over one set of mesh axes, queries optionally
                over another);
``backend``  -- the pre-placed search callable a ``ServingCell`` serves.
"""
from repro_torch.distributed.backend import ShardedSearchBackend
from repro_torch.distributed.sharding import (
    LOCAL_PLAN,
    MULTI_POD_PLAN,
    SINGLE_POD_PLAN,
    ForestShardShapes,
    ShardPlan,
    forest_shard_shapes,
    make_sharded_brute_fn,
    make_sharded_forest_fn,
    make_sharded_ivf_fn,
    shard_forest,
    sharded_brute_search,
    sharded_forest_search,
    sharded_ivf_search,
    slice_forest_delta,
    slice_ivf_delta,
)

__all__ = [
    "ShardPlan", "SINGLE_POD_PLAN", "MULTI_POD_PLAN", "LOCAL_PLAN",
    "sharded_brute_search", "sharded_ivf_search", "sharded_forest_search",
    "make_sharded_brute_fn", "make_sharded_ivf_fn", "make_sharded_forest_fn",
    "shard_forest", "forest_shard_shapes", "ForestShardShapes",
    "slice_forest_delta", "slice_ivf_delta",
    "ShardedSearchBackend",
]
