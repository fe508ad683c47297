"""Recall metrics.

Mirrors `diskann-benchmark-core/src/recall.rs:146` (`recall::knn`): recall@k is
the mean over queries of |result ∩ groundtruth_k| / k, with the reference's
distance-tie tolerance handled by comparing against the groundtruth *ids* of
the top-k (ties beyond position k may lower measured recall identically in
both frameworks, which is what the A/B gates compare).
"""

from __future__ import annotations

import numpy as np


def knn_recall(result_ids: np.ndarray, gt_ids: np.ndarray, k: int) -> float:
    """result_ids: [B, >=k] returned ids; gt_ids: [B, >=k] true ids."""
    result_ids = np.asarray(result_ids)[:, :k]
    gt_ids = np.asarray(gt_ids)[:, :k]
    hits = 0
    for r, g in zip(result_ids, gt_ids):
        hits += len(np.intersect1d(r[r >= 0], g[g >= 0]))
    return hits / (gt_ids.shape[0] * k)


def knn_recall_with_ties(
    result_dists: np.ndarray,
    gt_dists: np.ndarray,
    k: int,
    *,
    rtol: float = 1e-4,
    atol: float = 1e-4,
) -> float:
    """Distance-based recall@k: a hit is any returned entry whose distance is
    within tolerance of the groundtruth k-th distance.  Robust to ties and to
    f32 reduction-order differences (the reference's recall harness compares
    ids but its CI tolerates 1% recall noise for the same reason,
    `perf_test_inputs/disk-index-tolerances.json:13`)."""
    rd = np.asarray(result_dists)[:, :k]
    kth = np.asarray(gt_dists)[:, k - 1 : k]
    # abs() keeps the tolerance one-sided for negative distances (IP scores)
    hits = (rd <= kth + rtol * np.abs(kth) + atol).sum(axis=1).clip(max=k)
    return float(hits.mean() / k)


def average_precision(result_ids: np.ndarray, gt_ids: np.ndarray) -> float:
    """Mean average precision (reference `recall.rs:319`)."""
    result_ids = np.asarray(result_ids)
    gt_ids = np.asarray(gt_ids)
    aps = []
    for r, g in zip(result_ids, gt_ids):
        gset = set(int(x) for x in g[g >= 0])
        if not gset:
            continue
        hits, precision_sum = 0, 0.0
        for rank, rid in enumerate(r[r >= 0], start=1):
            if int(rid) in gset:
                hits += 1
                precision_sum += hits / rank
        aps.append(precision_sum / len(gset))
    return float(np.mean(aps)) if aps else 0.0
