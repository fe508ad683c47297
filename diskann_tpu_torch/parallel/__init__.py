"""Partitioning for memory-budgeted builds (the part of
`diskann_tpu/parallel/` that the merged build needs; the sharded graph
and flat search are not ported yet)."""

from diskann_tpu_torch.parallel.partition import (
    estimate_build_ram_bytes, kmeans_partition, shard_lists,
)

__all__ = ["kmeans_partition", "shard_lists", "estimate_build_ram_bytes"]
