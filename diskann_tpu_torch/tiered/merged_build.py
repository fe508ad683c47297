"""Memory-budgeted merged Vamana build (PyTorch port of
`diskann_tpu/tiered/merged_build.py`; the reference's
`MergedVamanaIndexBuilder`).

When a dataset's build does not fit the card, k-means it into shards,
assign every vector to its ``overlap`` (2) nearest shards, build each shard
on the card in turn (one shard resident at a time), and merge the shards'
adjacency by id union into one graph, served as a `TieredIndex`: the codes
and the graph on the card, the full vectors on the host.

While a shard's vectors are still on the card after its build, one
batched gather and product gives every edge's exact length; the merge
then needs no distance math: dedup by id, rank-interleave, cap at R.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from diskann_tpu_torch.devices import default_device
from diskann_tpu_torch.graph import packed as packed_mod
from diskann_tpu_torch.graph import state as graph_state
from diskann_tpu_torch.graph.config import GraphConfig
from diskann_tpu_torch.graph.index import GraphIndex
from diskann_tpu_torch.graph.scorers import sq_aux_norms, sq_center_codes
from diskann_tpu_torch.ops.distance import Metric, distance_to_set
from diskann_tpu_torch.ops.topk import sort_with
from diskann_tpu_torch.parallel.partition import estimate_build_ram_bytes
from diskann_tpu_torch.quant.kmeans import kmeans
from diskann_tpu_torch.quant.pq import train_pq
from diskann_tpu_torch.quant.scalar import train_scalar
from diskann_tpu_torch.tiered.index import HostVectorStore, TieredIndex

_RANK_PAD = 2**30   # rank sentinel for empty slots
# rows per chunk of the host-to-card encodes and of the packed refresh
_ENCODE_ROWS = 1 << 18
_REFRESH_ROWS = 1 << 15


def _assign_chunked(vectors: np.ndarray, centers, overlap: int, *,
                    chunk: int = 1 << 18, device=None) -> np.ndarray:
    """[N, overlap] int32 nearest shard ids per row, closest first (ties to
    the lower id); the vectors stream through ``device`` a chunk at a
    time."""
    n = vectors.shape[0]
    out = np.empty((n, overlap), np.int32)
    centers = torch.as_tensor(np.asarray(centers, np.float32), device=device)
    for lo in range(0, n, chunk):
        xc = torch.from_numpy(np.ascontiguousarray(vectors[lo:lo + chunk], np.float32))
        d = distance_to_set(xc.to(device), centers, Metric.L2)
        top = torch.sort(d, dim=1, stable=True).indices[:, :overlap]
        out[lo:lo + xc.shape[0]] = top.cpu().numpy()
    return out


def _edge_lengths(vectors, sq_norms, adjacency, *, chunk: int = 32768) -> torch.Tensor:
    """Exact squared length of every adjacency edge, [rows, Rs] float32, inf
    for empty slots, on the vectors' device.

    Row chunks bound the neighbour gather: all rows at once would
    materialize [rows, Rs, d] float32, 26.6 GB at a 1M-row shard with
    Rs=52 and d=128."""
    ns = vectors.shape[0]
    out = torch.empty(adjacency.shape, dtype=torch.float32, device=adjacency.device)
    for lo in range(0, adjacency.shape[0], chunk):
        adj = adjacency[lo:lo + chunk]
        safe = adj.long().clamp(0, ns - 1)
        dots = (vectors[safe] @ vectors[lo:lo + chunk, :, None]).squeeze(-1)
        d2 = sq_norms[lo:lo + chunk, None] + sq_norms[safe] - 2.0 * dots
        out[lo:lo + chunk] = torch.where(adj >= 0, d2.clamp_min(0.0), float("inf"))
    return out


def _merge_rows(ids_a, r_a, d_a, ids_b, r_b, d_b, cap: int):
    """Merge two edge lists per row ([M, *] int32 ids and ranks, float32
    lengths; tensors on any device): dedup by id keeping the best (rank,
    length), drop -1, then rank-interleave (each edge's position in its
    shard's prune output first, exact length breaking ties across shards)
    and keep ``cap``.  Returns (ids, ranks, lengths), so a row in a third
    shard folds into its running merge.

    Rank-interleaving keeps each shard's alpha-diverse order; ranking by
    raw length collapses when three or more lists merge (the reference
    measured recall 0.81 against 0.96 at overlap 3).  numpy's three-key
    ``lexsort`` is two stable sorts here: by length, then by (id, rank)
    packed into one int64 key."""
    ids = torch.cat([ids_a, ids_b], 1)
    rs = torch.cat([r_a, r_b], 1)
    ds = torch.cat([d_a, d_b], 1)
    ds = torch.where(ids >= 0, ds, float("inf"))
    rs = torch.where(ids >= 0, rs, _RANK_PAD)
    # (id, rank, length) order: duplicate ids land adjacent, best first
    ds, ids, rs = sort_with(ds, ids, rs)
    _, ids, rs, ds = sort_with(ids.long() * 2**31 + rs, ids, rs, ds)
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    invalid = dup | (ids < 0)
    ds = torch.where(invalid, float("inf"), ds)
    rs = torch.where(invalid, _RANK_PAD, rs)
    # interleave: rank first, exact length breaks rank ties across shards
    ds, ids, rs = sort_with(ds, ids, rs)
    rs, ids, ds = (t[:, :cap] for t in sort_with(rs, ids, ds))
    return torch.where(torch.isfinite(ds), ids, -1), rs, ds


def _pad_cols(a: np.ndarray, width: int, fill) -> np.ndarray:
    return np.pad(a, ((0, 0), (0, width - a.shape[1])), constant_values=fill)


def plan_shards(n: int, dim: int, r_slack: int, *, dp: int, overlap: int,
                hbm_budget_bytes: int) -> int:
    """Number of shards so each shard's build fits the budget."""
    per_pt = estimate_build_ram_bytes(1 << 20, dim, r_slack, dp) / (1 << 20)
    budget_pts = max(int(hbm_budget_bytes / per_pt), 1)
    return max(math.ceil(n * overlap / budget_pts), 1)


def _merge_state(n: int, r_slack: int, checkpoint_dir: str | None, log):
    """(merged ids, ranks, lengths, seen, shards done, progress file): host
    arrays, or memmapped ``.npy`` files in ``checkpoint_dir`` that a
    restarted build with the same arguments resumes from."""
    if not checkpoint_dir:
        return (np.full((n, r_slack), -1, np.int32),
                np.full((n, r_slack), _RANK_PAD, np.int32),
                np.full((n, r_slack), np.inf, np.float32),
                np.zeros((n,), bool), set(), None)
    from numpy.lib.format import open_memmap

    os.makedirs(checkpoint_dir, exist_ok=True)
    prog = os.path.join(checkpoint_dir, "shards_done.txt")
    fresh = not os.path.exists(os.path.join(checkpoint_dir, "merged.npy"))

    def mm(name, dtype, shape, fill):
        p = os.path.join(checkpoint_dir, name)
        if fresh:
            a = open_memmap(p, mode="w+", dtype=dtype, shape=shape)
            a[:] = fill
        else:
            a = open_memmap(p, mode="r+")
            if a.shape != shape:
                raise ValueError(f"checkpoint {name}: shape {a.shape}, want {shape}")
        return a

    arrays = (mm("merged.npy", np.int32, (n, r_slack), -1),
              mm("merged_r.npy", np.int32, (n, r_slack), _RANK_PAD),
              mm("merged_d.npy", np.float32, (n, r_slack), np.inf),
              mm("seen.npy", bool, (n,), False))
    done: set[int] = set()
    if not fresh and os.path.exists(prog):
        with open(prog) as f:
            done = {int(v) for v in f.read().split()}
        log(f"resuming: shards {sorted(done)} already merged")
    return (*arrays, done, prog)


def build_merged(
    vectors: np.ndarray,
    config: GraphConfig | None = None,
    *,
    hbm_budget_bytes: int | None = None,
    n_shards: int | None = None,
    overlap: int = 2,
    dp: int = 64,
    insert_batch_size: int = 4096,
    train_points: int = 1 << 16,
    seed: int = 0,
    verbose: bool = False,
    codes: str = "packed",
    pq_chunks: int = 32,
    pq_centers: int = 256,
    adj_width: int | None = None,
    checkpoint_dir: str | None = None,
    device=None,
    **build_kw,
) -> TieredIndex:
    """Build a `TieredIndex` for a dataset whose build does not fit the
    card.

    ``vectors`` stays a host array; at most one shard's build is on
    ``device`` (the CUDA card by default) at a time.  With ``n_shards``
    unset, the count comes from ``hbm_budget_bytes`` (default: 60% of the
    card's memory); when everything fits one shard, this is
    `TieredIndex.build_from_host`.

    codes: the traversal representation kept on the card: "packed" (fat
    rows, the fastest walk, ~nwr * 512 B per point), "sq" (full-dimension
    int8 codes, near-exact ordering) or "pq" (``pq_chunks`` x
    ``pq_centers`` ADC codes, for the largest collections).  adj_width:
    keep only the first (best-ranked) columns of the read-only merged
    adjacency.  checkpoint_dir: keep the merge state in memmapped files
    there and record finished shards, so a restarted build with the same
    arguments skips them (the partition is seeded).  build_kw go to each
    shard's `GraphIndex.build`."""
    if codes not in ("packed", "sq", "pq"):
        raise ValueError(f"unknown codes {codes!r}")
    device = default_device(device)
    vectors = np.asarray(vectors, np.float32)
    n, dim = vectors.shape
    config = config or GraphConfig()
    r_slack = config.max_degree_with_slack
    if n_shards is None:
        if hbm_budget_bytes is None:
            total = (torch.cuda.mem_get_info(device)[1] if device.type == "cuda"
                     else 16 * (1 << 30))
            hbm_budget_bytes = int(total * 0.6)
        n_shards = plan_shards(n, dim, r_slack, dp=dp, overlap=overlap,
                               hbm_budget_bytes=hbm_budget_bytes)
        if n_shards > 1:
            # n_shards <= overlap puts every vector in every shard
            n_shards = max(n_shards, overlap + 1)
    if n_shards <= 1:
        return TieredIndex.build_from_host(
            vectors, config, dp=dp, insert_batch_size=insert_batch_size,
            build_mode="packed", packed_dp=dp, device=device, **build_kw)

    log = (lambda *a: print("[merged]", *a, flush=True)) if verbose else (lambda *a: None)

    # ---- partition: k-means on a sample, chunked overlap assignment ----
    rng = np.random.default_rng(seed)
    sample = vectors[rng.choice(n, size=min(train_points, n), replace=False)]
    sample_d = torch.from_numpy(sample).to(device)
    centers, _ = kmeans(sample_d, n_shards, max_train_points=train_points, seed=seed)
    assign = _assign_chunked(vectors, centers.cpu().numpy(), overlap, device=device)
    log(f"partitioned n={n} into {n_shards} shards (overlap={overlap})")

    # ---- per-shard build, merged into the global adjacency as it goes ----
    cap = max(n, insert_batch_size)
    merged, merged_r, merged_d, seen, done, prog = _merge_state(
        n, r_slack, checkpoint_dir, log)
    # one capacity for every shard, as in the reference
    shard_sizes = [int((assign == s).any(axis=1).sum()) for s in range(n_shards)]
    shard_cap = -(-max(shard_sizes + [insert_batch_size]) // insert_batch_size) \
        * insert_batch_size
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    for s in range(n_shards):
        if s in done:
            continue
        rows = np.nonzero((assign == s).any(axis=1))[0].astype(np.int64)
        if rows.size == 0:
            continue
        ns = len(rows)
        idx = GraphIndex.build(
            vectors[rows], config, insert_batch_size=min(insert_batch_size, ns),
            build_mode="packed", packed_dp=dp, capacity=shard_cap, device=device,
            **build_kw)
        lengths = _edge_lengths(idx.state.vectors, idx.state.sq_norms,
                                idx.state.adjacency)[:ns].cpu().numpy()
        adj_local = idx.state.adjacency[:ns].cpu().numpy()
        del idx   # free the shard's tables before the next build
        adj_global = np.where(adj_local >= 0, rows[np.clip(adj_local, 0, ns - 1)],
                              -1).astype(np.int32)
        old = seen[rows]
        fresh = rows[~old]
        # an edge's rank is its position in this shard's prune output
        ranks = np.broadcast_to(np.arange(adj_global.shape[1], dtype=np.int32),
                                adj_global.shape)
        ranks = np.where(adj_global >= 0, ranks, _RANK_PAD)
        merged[fresh] = adj_global[~old]
        merged_r[fresh] = ranks[~old]
        merged_d[fresh] = lengths[~old]
        both = rows[old]
        if both.size:
            # one pairwise merge per extra shard a row belongs to
            mi, mr, md = (t.cpu().numpy() for t in _merge_rows(
                dev(merged[both]), dev(merged_r[both]), dev(merged_d[both]),
                dev(adj_global[old]), dev(ranks[old]), dev(lengths[old]),
                config.max_degree))
            merged[both] = _pad_cols(mi, r_slack, -1)
            merged_r[both] = _pad_cols(mr, r_slack, _RANK_PAD)
            merged_d[both] = _pad_cols(md, r_slack, np.inf)
        seen[rows] = True
        if checkpoint_dir:
            for a in (merged, merged_r, merged_d, seen):
                a.flush()
            with open(prog, "a") as f:
                f.write(f"{s}\n")
        log(f"shard {s}: built {ns} pts, merged")

    # ---- the tiered graph: adjacency and codes on the card, vectors not ----
    graph = GraphIndex(dim, config, capacity=1, insert_batch_size=insert_batch_size,
                       search_batch_size=build_kw.get("search_batch_size", 4096),
                       device=device)
    aw = min(adj_width or r_slack, r_slack)
    adj_host = merged[:, :aw]   # rank-ordered rows: the first aw are the best
    adjacency = torch.full((cap, aw), -1, dtype=torch.int32, device=device)
    adjacency[:n] = dev(adj_host)
    valid = torch.zeros((cap,), dtype=torch.bool, device=device)
    valid[:n] = True
    graph.state = graph_state.GraphArrays(
        vectors=torch.zeros((1, dim), device=device),
        sq_norms=torch.zeros((1,), device=device),
        adjacency=adjacency,
        degrees=(adjacency >= 0).sum(1, dtype=torch.int32),
        valid=valid,
        vec_sum=dev(vectors.sum(axis=0, dtype=np.float64).astype(np.float32)),
    )
    graph.n = n
    graph._hbm_vectors_dropped = True

    def chunks():
        # the vectors visit the card one chunk at a time
        for lo in range(0, n, _ENCODE_ROWS):
            yield lo, dev(vectors[lo:lo + _ENCODE_ROWS])

    if codes == "pq":
        pq = train_pq(sample_d, n_chunks=pq_chunks, n_centers=pq_centers,
                      max_train_points=train_points, seed=seed)
        graph.pq = pq
        graph.pq_codes = torch.zeros((cap, pq.n_chunks), dtype=torch.uint8, device=device)
        for lo, xc in chunks():
            graph.pq_codes[lo:lo + xc.shape[0]] = pq.encode(xc)
    elif codes == "sq":
        sq = train_scalar(sample_d, n_bits=8, sigma=4.0)
        graph.sq = sq
        graph.sq_codes = torch.zeros((cap, dim), dtype=torch.int8, device=device)
        graph.sq_aux = torch.zeros((cap,), device=device)
        for lo, xc in chunks():
            ci8, graph.sq_bias2 = sq_center_codes(sq.encode(xc), sq.scale, sq.bias)
            graph.sq_codes[lo:lo + xc.shape[0]] = ci8
            graph.sq_aux[lo:lo + xc.shape[0]] = sq_aux_norms(ci8, sq.scale)
    else:
        proj, pscale, pbias2 = packed_mod.train_packed(sample, min(dp, dim), config.metric,
                                                       device=device)
        p = packed_mod.alloc_packed(proj, pscale, pbias2, cap, aw)
        for lo, xc in chunks():
            c, a = packed_mod.encode(p, xc, config.metric)
            packed_mod.set_self_codes(p, torch.arange(lo, lo + xc.shape[0], device=device),
                                      c, a)
        for lo in range(0, n, _REFRESH_ROWS):
            packed_mod.refresh_rows(p, adjacency,
                                    torch.arange(lo, min(lo + _REFRESH_ROWS, n), device=device))
        graph.packed = p

    # ---- entry point: the medoid, approximated on the host ----
    step = max(n // (1 << 16), 1)
    mu = vectors.mean(axis=0)
    probe = vectors[::step]
    medoid_row = int(np.argmin(((probe - mu) ** 2).sum(axis=1)))
    graph._cached_start = torch.tensor([medoid_row * step], dtype=torch.int32, device=device)
    log("assembled merged tiered index")
    return TieredIndex(graph, HostVectorStore(vectors))
