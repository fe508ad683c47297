"""Shard partitioning for memory-budgeted builds (PyTorch port of
`diskann_tpu/parallel/partition.py`).

K-means the dataset into shards, assign every vector to its ``overlap``
closest shards (2 by default: the overlap keeps neighbourhoods that cross
a shard boundary searchable after the merge), build each shard on its own
and merge by id union (`tiered/merged_build.py`)."""

from __future__ import annotations

import numpy as np
import torch

from diskann_tpu_torch.devices import default_device
from diskann_tpu_torch.ops.distance import Metric, distance_to_set
from diskann_tpu_torch.quant.kmeans import kmeans


def kmeans_partition(vectors, n_shards: int, *, overlap: int = 2, seed: int = 0,
                     train_points: int = 1 << 16, device=None):
    """Returns (centers [n_shards, d], assignments [N, overlap] int64): each
    row's ``overlap`` nearest shard ids, closest first (ties to the lower
    id).  A tensor is partitioned on its own device, numpy input on
    ``device`` (the CUDA card by default); the k-means draws from a
    generator seeded with ``seed``."""
    if isinstance(vectors, torch.Tensor):
        v = vectors.float()
    else:
        v = torch.as_tensor(np.asarray(vectors, np.float32), device=default_device(device))
    centers, _ = kmeans(v, n_shards, max_train_points=train_points, seed=seed)
    d = distance_to_set(v, centers, Metric.L2)
    order = torch.argsort(d, dim=1, stable=True)[:, :overlap]
    return centers.cpu().numpy(), order.cpu().numpy().astype(np.int64)


def shard_lists(assignments: np.ndarray, n_shards: int) -> list[np.ndarray]:
    """Invert [N, overlap] assignments into per-shard row lists."""
    return [np.nonzero((assignments == s).any(axis=1))[0] for s in range(n_shards)]


def estimate_build_ram_bytes(n: int, dim: int, r_slack: int, dp: int = 32) -> int:
    """Device-memory estimate for one shard's build: vectors + adjacency +
    packed tables, plus 40% of working buffers."""
    vectors = n * dim * 4
    adjacency = n * r_slack * 4
    packed = n * r_slack * dp + n * r_slack * 4 + n * dp
    return int((vectors + adjacency + packed) * 1.4)
