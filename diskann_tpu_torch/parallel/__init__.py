"""Sharding over one device or several: the sharded graph index and flat
search, the mesh of one worker process per card, and the partitioning for
memory-budgeted builds."""

from diskann_tpu_torch.parallel.partition import (
    estimate_build_ram_bytes, kmeans_partition, shard_lists,
)
from diskann_tpu_torch.parallel.mesh import Mesh
from diskann_tpu_torch.parallel.sharded import ShardedGraphIndex, sharded_flat_search

__all__ = ["Mesh", "ShardedGraphIndex", "sharded_flat_search", "kmeans_partition",
           "shard_lists", "estimate_build_ram_bytes"]
