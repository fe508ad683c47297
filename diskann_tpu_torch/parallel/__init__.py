"""Sharding on one device: the sharded graph index and flat search, and
the partitioning for memory-budgeted builds."""

from diskann_tpu_torch.parallel.partition import (
    estimate_build_ram_bytes, kmeans_partition, shard_lists,
)
from diskann_tpu_torch.parallel.sharded import ShardedGraphIndex, sharded_flat_search

__all__ = ["ShardedGraphIndex", "sharded_flat_search", "kmeans_partition",
           "shard_lists", "estimate_build_ram_bytes"]
