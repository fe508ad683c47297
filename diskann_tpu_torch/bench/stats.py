"""Latency percentile utilities (reference:
`diskann-benchmark-runner/src/utils/percentiles.rs`)."""

from __future__ import annotations

import numpy as np


def percentile_summary(latencies_s: np.ndarray) -> dict:
    lat = np.asarray(latencies_s, np.float64)
    if lat.size == 0:
        return {}
    return {
        "mean_ms": float(lat.mean() * 1e3),
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p90_ms": float(np.percentile(lat, 90) * 1e3),
        "p95_ms": float(np.percentile(lat, 95) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "max_ms": float(lat.max() * 1e3),
    }
