"""Measurement harnesses (PyTorch port of `diskann_tpu/bench/harness.py`):
synthetic data, build timing, search sweeps with recall and latency
percentiles, and the standard benchmark families of the registry.

Every family takes the job keys of the reference's, plus ``"device"``:
where the index and the scans run, the CUDA card by default.  The data is
made on the host with numpy from ``"seed"`` (the reference's
``"device_data"`` key, which made it with JAX's generator on the
accelerator, is ignored: the port's data is the reference's
``device_data=False`` data)."""

from __future__ import annotations

import time

import numpy as np
import torch

from diskann_tpu_torch.bench.recall import knn_recall
from diskann_tpu_torch.bench.registry import Registry
from diskann_tpu_torch.bench.stats import percentile_summary
from diskann_tpu_torch.devices import default_device
from diskann_tpu_torch.flat.index import FlatIndex
from diskann_tpu_torch.graph.config import GraphConfig
from diskann_tpu_torch.graph.index import GraphIndex
from diskann_tpu_torch.ops.distance import Metric


def make_clustered(seed, n, nq, d, n_clusters=1024, sigma=0.3):
    """Synthetic clustered dataset (queries drawn from the same mixture):
    the same arrays as the reference's ``make_clustered(..., device=False)``
    for the same seed."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    a = rng.integers(0, n_clusters, size=n)
    x = centers[a] + sigma * rng.standard_normal((n, d)).astype(np.float32)
    aq = rng.integers(0, n_clusters, size=nq)
    q = centers[aq] + sigma * rng.standard_normal((nq, d)).astype(np.float32)
    return x, q


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_build(vectors, config: GraphConfig, *, insert_batch_size=1024, **kw) -> dict:
    """Time `GraphIndex.build` (kw: build options and ``device``) up to
    the device's last write."""
    t0 = time.time()
    idx = GraphIndex.build(vectors, config, insert_batch_size=insert_batch_size, **kw)
    _sync(idx.device)
    dt = time.time() - t0
    return {
        "index": idx,
        "build_s": dt,
        "points_per_s": len(vectors) / dt if dt > 0 else float("inf"),
    }


def run_search_sweep(
    index: GraphIndex,
    queries: np.ndarray,
    gt_ids: np.ndarray,
    *,
    k: int = 10,
    l_values=(20, 50, 100),
    mode: str = "full",
    beam_width: int | None = None,
    repeats: int = 3,
) -> list[dict]:
    """QPS / recall / latency for each search-list size L, best of
    ``repeats`` timed calls after one warm-up (`search` returns host arrays,
    so each call ends with the device's results on the host)."""
    out = []
    b = len(queries)
    for l in l_values:
        index.search(queries[: min(64, b)], k, l_search=l, mode=mode,
                     beam_width=beam_width)
        lat = []
        ids = None
        for _ in range(repeats):
            t0 = time.time()
            _, ids, stats = index.search(
                queries, k, l_search=l, mode=mode, beam_width=beam_width
            )
            lat.append(time.time() - t0)
        dt = min(lat)
        out.append({
            "l_search": l,
            "k": k,
            "mode": mode,
            "recall": knn_recall(ids, gt_ids, k),
            "qps": b / dt,
            "mean_cmps": float(stats.cmps.mean()),
            "mean_hops": float(stats.hops.mean()),
            "latency": percentile_summary(np.array([dt / b] * 1)),
        })
    return out


# ----------------------------------------------------------- registrations
def default_registry() -> Registry:
    """The shipped benchmark families, under the reference's names."""
    reg = Registry()

    def graph_index_job(job: dict) -> dict:
        n = job.get("n", 100_000)
        d = job.get("dim", 64)
        nq = job.get("n_queries", 1000)
        device = default_device(job.get("device"))
        cfg = GraphConfig(
            max_degree=job.get("max_degree", 32),
            l_build=job.get("l_build", 64),
            alpha=job.get("alpha", 1.2),
            metric=Metric(job.get("metric", "l2")),
        )
        x, q = make_clustered(job.get("seed", 0), n, nq, d)
        built = run_build(
            x, cfg, insert_batch_size=job.get("insert_batch_size", 1024),
            device=device,
        )
        idx = built.pop("index")
        flat = FlatIndex(x, cfg.metric, device=device)
        _, gt = flat.search(q, k=job.get("k", 10))
        sweeps = run_search_sweep(
            idx, q, gt,
            k=job.get("k", 10),
            l_values=tuple(job.get("search_l", (20, 50, 100))),
            mode=job.get("search_mode", "full"),
            beam_width=job.get("beam_width"),
        )
        return {"build": built, "search": sweeps}

    def flat_job(job: dict) -> dict:
        n = job.get("n", 100_000)
        d = job.get("dim", 64)
        nq = job.get("n_queries", 1000)
        device = default_device(job.get("device"))
        x, q = make_clustered(job.get("seed", 0), n, nq, d)
        flat = FlatIndex(x, Metric(job.get("metric", "l2")), device=device)
        flat.search(q[:8], k=job.get("k", 10))  # warm-up
        t0 = time.time()
        flat.search(q, k=job.get("k", 10))
        dt = time.time() - t0
        return {"qps": nq / dt, "recall": 1.0}

    def filters_job(job: dict) -> dict:
        """Filtered-search family: recall against the exact scan of the
        matching points, and QPS."""
        from diskann_tpu_torch.filters import compile_accept, parse_predicate

        rng = np.random.default_rng(job.get("seed", 0))
        n = job.get("n", 20_000)
        d = job.get("dim", 32)
        nq = job.get("n_queries", 200)
        device = default_device(job.get("device"))
        labels = job.get("labels", ["red", "green", "blue", "round"])
        predicate = job.get("predicate", labels[0])
        x, q = make_clustered(job.get("seed", 0), n, nq, d)
        cfg = GraphConfig(
            max_degree=job.get("max_degree", 32),
            l_build=job.get("l_build", 64),
        )
        idx = GraphIndex.build(
            x, cfg, insert_batch_size=job.get("insert_batch_size", 1024),
            device=device,
        )
        per_point = [
            [l for l in labels if rng.random() < 0.3] for _ in range(n)
        ]
        idx.attach_labels(per_point)
        k = job.get("k", 10)
        # exact filtered groundtruth by brute force over matching points
        cap = idx.state.capacity
        accept = compile_accept(parse_predicate(predicate), idx.labels.vocab, cap)
        match = accept(idx.labels.bits, torch.arange(cap, device=device),
                       torch.ones(cap, dtype=torch.bool, device=device))
        match = match[:n].cpu().numpy()
        sub = np.nonzero(match)[0]
        flat = FlatIndex(x[sub], cfg.metric, device=device)
        _, gt_local = flat.search(q, k=k)
        gt = np.where(gt_local >= 0, sub[np.clip(gt_local, 0, len(sub) - 1)], -1)
        idx.search_filtered(q[:8], predicate, k)  # warm-up
        t0 = time.time()
        _, ids, stats = idx.search_filtered(
            q, predicate, k, l_search=job.get("search_l", 100),
            method=job.get("method", "inline"),
        )
        dt = time.time() - t0
        return {
            "selectivity": float(match.mean()),
            "recall": knn_recall(ids, gt, k),
            "qps": nq / dt,
            "mean_cmps": float(stats.cmps.mean()),
        }

    def multivec_job(job: dict) -> dict:
        """Multi-vector (Chamfer / MaxSim) scan throughput."""
        from diskann_tpu_torch.ops.multivec import FlatMultiVectorIndex

        rng = np.random.default_rng(job.get("seed", 0))
        n_docs = job.get("n_docs", 2000)
        tpd = job.get("tokens_per_doc", 16)
        d = job.get("dim", 64)
        nq = job.get("n_queries", 50)
        docs = [rng.standard_normal((tpd, d)).astype(np.float32)
                for _ in range(n_docs)]
        qs = [rng.standard_normal((tpd, d)).astype(np.float32)
              for _ in range(nq)]
        idx = FlatMultiVectorIndex(docs, metric=job.get("kind", "maxsim"),
                                   device=job.get("device"))
        idx.search(qs[:4], k=job.get("k", 10))  # warm-up
        t0 = time.time()
        idx.search(qs, k=job.get("k", 10))
        dt = time.time() - t0
        return {"qps": nq / dt, "n_docs": n_docs, "tokens_per_doc": tpd}

    def streaming_job(job: dict) -> dict:
        """Streaming churn: insert / delete / search / consolidate steps
        with recall checkpoints."""
        from diskann_tpu_torch.bench.runbook import RunbookExecutor

        n = job.get("n", 20_000)
        d = job.get("dim", 32)
        nq = job.get("n_queries", 200)
        x, q = make_clustered(job.get("seed", 0), n, nq, d)
        cfg = GraphConfig(
            max_degree=job.get("max_degree", 32),
            l_build=job.get("l_build", 64),
        )
        idx = GraphIndex(d, cfg, insert_batch_size=job.get("insert_batch_size", 1024),
                         device=job.get("device"))
        ex = RunbookExecutor(idx, x, q, k=job.get("k", 10))
        steps = job.get("steps") or [
            {"operation": "insert", "start": 0, "end": n // 2},
            {"operation": "search"},
            {"operation": "delete", "start": 0, "end": n // 4},
            {"operation": "insert", "start": n // 2, "end": n},
            {"operation": "search"},
            {"operation": "consolidate"},
            {"operation": "search"},
        ]
        return {"log": ex.run(steps)}

    from diskann_tpu_torch.bench.kernels import kernels_job

    reg.register("graph-index", graph_index_job,
                 "build + search sweep on synthetic clustered data")
    reg.register("flat", flat_job, "brute-force scan throughput")
    reg.register("kernels", kernels_job,
                 "device op microbenchmarks (SIMD-bench analogue)")
    reg.register("filters", filters_job,
                 "label-filtered search recall/QPS")
    reg.register("multi-vector", multivec_job,
                 "Chamfer/MaxSim multi-vector scan throughput")
    reg.register("streaming", streaming_job,
                 "streaming churn runbook with recall checkpoints")
    return reg
