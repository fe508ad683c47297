"""The port's tiered index and merged build against the JAX package's.

One JAX tiered index (`TieredIndex.build_from_host`, n=2000 x 16
clustered, R=12, L=24, W=4, dp=16, labels attached) and one JAX
`build_merged` per traversal code (packed, sq, pq; 3 shards) are built per
module; their graphs are carried across by `convert.py` (vectors dropped,
start pinned) over the same host vectors.

- `search` / `search_batched` (with and without the router, float16 rows,
  small batches, io_limit) and `search_filtered` give JAX's ids, `cmps` and
  hops bitwise on the packed, sq and pq walks; `search_range` gives JAX's
  sets.
- Tiered records cross packages both ways (`TieredIndex.save` / `load`).
- The merge helpers (`_merge_rows`, `_edge_lengths`, `_assign_chunked`,
  `_pad_cols`, `plan_shards`) equal JAX's on the same inputs; the port's
  own `build_merged` keeps every invariant and JAX's recall within 0.02
  for each code (the k-means draws differ), as do `adj_width`, checkpoint
  resume and the single-shard delegation.
- A graph whose vectors were dropped keeps the reference's guards, and
  `SqliteVectorStore` plugs into the pipeline.
"""

import hashlib

import numpy as np
import pytest
import torch

from diskann_tpu import GraphConfig as JConfig
from diskann_tpu import GraphIndex as JIndex
from diskann_tpu.tiered import TieredIndex as JTiered
from diskann_tpu.tiered import merged_build as jmb
from diskann_tpu_torch import FlatIndex, GraphConfig, GraphIndex
from diskann_tpu_torch.bench.harness import make_clustered
from diskann_tpu_torch.bench.recall import knn_recall
from diskann_tpu_torch.convert import graph_index_from_arrays
from diskann_tpu_torch.io_ import write_fbin
from diskann_tpu_torch.parallel import kmeans_partition, shard_lists
from diskann_tpu_torch.tiered import (
    HostVectorStore, SqliteVectorStore, TieredIndex, build_merged,
)
from diskann_tpu_torch.tiered import merged_build as pmb
from torch_port_helpers import CPU, jax_index_arrays, n, t

N, D, NQ = 2000, 16, 48
CFG = dict(max_degree=12, l_build=24, beam_width=4)
MERGED = dict(n_shards=3, dp=16, insert_batch_size=512, seed=3, pq_chunks=8)
CODES = ("packed", "sq", "pq")


def _hot():
    return np.arange(N) % 3 == 0


@pytest.fixture(scope="module")
def data():
    x, q = make_clustered(41, N, NQ, D, n_clusters=20, sigma=0.35)
    gt = FlatIndex(x, device=CPU).search(q, 10)[1]
    return x, q, n(gt)


@pytest.fixture(scope="module")
def jax_tiered(data):
    x, _, _ = data
    jt = JTiered.build_from_host(x, JConfig(**CFG), dp=16, insert_batch_size=512)
    jt.graph.attach_labels([["hot"] if h else ["cold"] for h in _hot()])
    return jt


class _ShardMemo:
    """Reuses `cls.build` results across calls with identical arguments:
    the partition is seeded, so the merged builds of one module (one per
    traversal code, and the checkpointed one) build the same shards, and
    only their assembly differs.  ``requests`` counts the builds asked
    for."""

    def __init__(self):
        self.cache, self.requests = {}, 0

    def patch(self, mp, cls):
        orig = cls.build.__func__

        def build(c, vectors, *a, **kw):
            self.requests += 1
            key = (hashlib.sha1(np.ascontiguousarray(vectors).tobytes()).hexdigest(),
                   repr(a), repr(sorted(kw.items())))
            if key not in self.cache:
                self.cache[key] = orig(c, vectors, *a, **kw)
            return self.cache[key]

        mp.setattr(cls, "build", classmethod(build))


@pytest.fixture(scope="module")
def jax_merged(data):
    x, _, _ = data
    with pytest.MonkeyPatch.context() as mp:
        _ShardMemo().patch(mp, JIndex)
        return {c: jmb.build_merged(x, JConfig(**CFG), codes=c, **MERGED) for c in CODES}


@pytest.fixture(scope="module")
def port_shards():
    return _ShardMemo()


def _carry(jt, x, **kw) -> TieredIndex:
    """The port's copy of JAX tiered index jt over the same host vectors."""
    g = graph_index_from_arrays(**jax_index_arrays(jt.graph), insert_batch_size=512)
    return TieredIndex(g, HostVectorStore(x), **kw)


def _same(got, want, what):
    np.testing.assert_array_equal(got[1], want[1], err_msg=what)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, err_msg=what)
    np.testing.assert_array_equal(got[2].cmps, want[2].cmps, err_msg=what)
    np.testing.assert_array_equal(got[2].hops, want[2].hops, err_msg=what)


# ---------------------------------------------------------- tiered search
SEARCHES = {
    "search": lambda ti, q: ti.search(q, 10, l_search=32),
    "batched_small": lambda ti, q: ti.search_batched(q, 10, l_search=32, batch_size=16),
    "rerank_l": lambda ti, q: ti.search_batched(q, 10, l_search=32, rerank_l=12, max_hops=9),
    "f16_rows": lambda ti, q: ti.search_batched(q, 10, l_search=32, row_wire=np.float16,
                                                query_dtype=np.float16),
    "filtered": lambda ti, q: ti.search_filtered(q, "hot", 10, l_search=40),
    "filtered_small": lambda ti, q: ti.search_filtered(q, "hot | cold", 5, l_search=24,
                                                       batch_size=16),
}


@pytest.mark.parametrize("router", [False, True], ids=["medoid", "router"])
@pytest.mark.parametrize("call", sorted(SEARCHES))
def test_tiered_search_matches_jax(data, jax_tiered, call, router):
    x, q, _ = data
    pt = _carry(jax_tiered, x)
    if router:
        jax_tiered.attach_router(256)
        pt.attach_router(256)
    else:
        jax_tiered._router_ids = None
    _same(SEARCHES[call](pt, q), SEARCHES[call](jax_tiered, q), call)
    if call == "search":
        assert pt.io_stats["rows_staged"] == NQ * 32


@pytest.mark.parametrize("io_limit", [12, 16])
def test_io_limit_matches_jax(data, jax_tiered, io_limit):
    x, q, _ = data
    jax_tiered._router_ids = None
    jax_tiered.io_limit = io_limit
    jax_tiered.io_stats = {"rows_staged": 0, "stage_s": 0.0}
    pt = _carry(jax_tiered, x, io_limit=io_limit)
    try:
        _same(pt.search(q, 10, l_search=32), jax_tiered.search(q, 10, l_search=32), "io")
        _same(pt.search_filtered(q, "hot", 10, l_search=32),
              jax_tiered.search_filtered(q, "hot", 10, l_search=32), "io filtered")
    finally:
        jax_tiered.io_limit = None
    assert pt.io_stats["rows_staged"] == jax_tiered.io_stats["rows_staged"] == 2 * NQ * io_limit


def test_reference_fault_io_limit_below_k(data, jax_tiered):
    """io_limit < k: the JAX package's pipeline writes [B, io_limit]
    results into its [B, k] output and raises; the port returns the
    io_limit reranked rows, padded with (inf, -1)."""
    x, q, _ = data
    jax_tiered._router_ids = None
    jax_tiered.io_limit = 6
    try:
        with pytest.raises(ValueError, match="broadcast"):
            jax_tiered.search(q, 10, l_search=32)
    finally:
        jax_tiered.io_limit = None
    d, ids, _ = _carry(jax_tiered, x, io_limit=6).search(q, 10, l_search=32)
    full_d, full_i, _ = _carry(jax_tiered, x, io_limit=32).search(q, 6, l_search=32, rerank_l=6)
    np.testing.assert_array_equal(ids[:, :6], full_i)
    np.testing.assert_allclose(d[:, :6], full_d)
    assert (ids[:, 6:] == -1).all() and np.isinf(d[:, 6:]).all()


@pytest.mark.parametrize("codes", CODES)
def test_merged_graph_search_matches_jax(data, jax_merged, codes):
    """The sq and pq walks (and their routers: int8 codes, PQ-decoded rows)
    on a JAX merged graph carried across."""
    x, q, _ = data
    jt = jax_merged[codes]
    pt = _carry(jt, x)
    for ti in (jt, pt):
        ti.attach_router(256)
    kw = dict(l_search=32, batch_size=16, router_starts=4, row_wire=np.float16)
    _same(pt.search_batched(q, 10, **kw), jt.search_batched(q, 10, **kw), codes)
    _same(pt.search(q, 10, l_search=24, mode=codes), jt.search(q, 10, l_search=24, mode=codes),
          codes)


def test_search_range_matches_jax(data, jax_tiered):
    x, q, _ = data
    jax_tiered._router_ids = None
    pt = _carry(jax_tiered, x)
    dall = ((q[:6, None, :] - x[None, :, :]) ** 2).sum(-1)
    radius = float(np.quantile(dall, 0.01))
    got = pt.search_range(q[:6], radius, l_init=32)
    want = jax_tiered.search_range(q[:6], radius, l_init=32)
    for b in range(6):
        assert set(got[b].tolist()) == set(want[b].tolist()), b
        assert (dall[b, got[b]] <= radius * (1 + 1e-5)).all()
    # a torch tensor of queries takes the same route
    got_t = pt.search_range(torch.from_numpy(q[:6]), radius, l_init=32)
    assert all(np.array_equal(a, b) for a, b in zip(got_t, got))


def test_tiered_records_cross_packages(data, jax_tiered, tmp_path):
    x, q, _ = data
    jax_tiered._router_ids = None
    jax_tiered.io_limit = 16
    try:
        jax_tiered.save(str(tmp_path / "jax"))
    finally:
        jax_tiered.io_limit = None
    pl = TieredIndex.load(str(tmp_path / "jax"), device=CPU)
    jl = JTiered.load(str(tmp_path / "jax"))
    assert pl.io_limit == jl.io_limit == 16 and pl.graph._hbm_vectors_dropped
    assert pl.store.is_native and pl.store.source_path.endswith("vectors.fbin")
    np.testing.assert_array_equal(n(pl.graph._cached_start), np.asarray(jl.graph._cached_start))
    _same(pl.search(q, 10, l_search=32), jl.search(q, 10, l_search=32), "jax record")
    pl.save(str(tmp_path / "port"))
    jp = JTiered.load(str(tmp_path / "port"))
    _same(jp.search(q, 10, l_search=32), pl.search(q, 10, l_search=32), "port record")
    assert jp.graph._hbm_vectors_dropped and jp.graph.state.vectors.shape[0] == 1


def test_port_tiered_round_trip_file_backed(data, tmp_path):
    """A port tier over an .fbin store saves its source path (copy_vectors
    False); the loaded tier returns identical results."""
    x, q, _ = data
    pt = TieredIndex.build_from_host(x, GraphConfig(**CFG), dp=16, insert_batch_size=512,
                                     device=CPU)
    assert pt.graph.state.vectors.shape[0] == 1 and pt.graph._cached_start is not None
    write_fbin(str(tmp_path / "v.fbin"), x)
    pt.store = HostVectorStore.from_fbin(str(tmp_path / "v.fbin"), cache_rows=128)
    pt.attach_router(256)
    pt.save(str(tmp_path / "rec"), copy_vectors=False)
    re = TieredIndex.load(str(tmp_path / "rec"), device=CPU)
    assert re.store.source_path == str(tmp_path / "v.fbin")
    re.attach_router(256)
    _same(re.search(q, 10, l_search=32), pt.search(q, 10, l_search=32), "round trip")


# ------------------------------------------------------------- merge helpers
def test_merge_rows_matches_jax():
    rng = np.random.default_rng(5)
    m, r = 400, 10

    def lists():
        ids = rng.integers(-1, 60, (m, r)).astype(np.int32)
        ranks = np.where(ids >= 0, np.arange(r, dtype=np.int32)[None], pmb._RANK_PAD)
        d = rng.integers(0, 8, (m, r)).astype(np.float32)   # many ties
        return ids, ranks.astype(np.int32), np.where(ids >= 0, d, np.inf).astype(np.float32)

    a, b = lists(), lists()
    want = jmb._merge_rows(*a, *b, 12)
    got = pmb._merge_rows(*(t(v) for v in a), *(t(v) for v in b), 12)
    for g, w in zip(got, want):
        assert n(g).dtype == w.dtype
        np.testing.assert_array_equal(n(g), w)
    np.testing.assert_array_equal(pmb._pad_cols(want[0], 15, -1), jmb._pad_cols(want[0], 15, -1))


def test_edge_lengths_and_assignment_match_jax():
    rng = np.random.default_rng(6)
    vecs = rng.standard_normal((700, 16)).astype(np.float32)
    sq = (vecs * vecs).sum(1)
    adj = rng.integers(-1, 700, (700, 9)).astype(np.int32)
    want = np.asarray(jmb._edge_lengths(vecs, sq, adj, chunk=256))
    got = n(pmb._edge_lengths(t(vecs), t(sq), t(adj), chunk=256))
    np.testing.assert_array_equal(np.isinf(got), adj < 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    centers = rng.standard_normal((7, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        pmb._assign_chunked(vecs, centers, 2, chunk=256, device=CPU),
        jmb._assign_chunked(vecs, centers, 2, chunk=256))


@pytest.mark.parametrize("budget", [1 << 40, 200 * (1 << 20), 1 << 30])
def test_plan_shards_matches_jax(budget):
    args = (1 << 20, 128, 83)
    kw = dict(dp=64, overlap=2, hbm_budget_bytes=budget)
    assert pmb.plan_shards(*args, **kw) == jmb.plan_shards(*args, **kw)


# ---------------------------------------------------------- the merged build
def _invariants(ti, nn):
    g = ti.graph
    adj = n(g.state.adjacency)[:nn]
    assert g.state.vectors.shape[0] == 1 and g.n == nn and g._hbm_vectors_dropped
    assert not (adj == np.arange(nn)[:, None]).any()
    srt = np.sort(np.where(adj < 0, 2**31 - 1, adj), axis=1)
    assert not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] < 2**31 - 1)).any()
    np.testing.assert_array_equal(n(g.state.degrees)[:nn], (adj >= 0).sum(1))
    assert (adj >= 0).sum(1).min() >= 1
    if g.packed is not None:
        cap, rs = g.state.adjacency.shape
        words = n(g.packed.rows).reshape(cap + 1, -1)[:cap, :rs]
        np.testing.assert_array_equal(words, n(g.state.adjacency))


@pytest.mark.parametrize("codes", CODES)
def test_build_merged_recall_near_jax(data, jax_merged, port_shards, codes, monkeypatch):
    x, q, gt = data
    port_shards.patch(monkeypatch, GraphIndex)
    pt = build_merged(x, GraphConfig(**CFG), codes=codes, device=CPU, **MERGED)
    _invariants(pt, N)
    jt = jax_merged[codes]
    assert pt.graph.state.adjacency.shape == tuple(jt.graph.state.adjacency.shape)
    np.testing.assert_array_equal(n(pt.graph._cached_start), np.asarray(jt.graph._cached_start))
    got = knn_recall(pt.search(q, 10, l_search=40)[1], gt, 10)
    want = knn_recall(jt.search(q, 10, l_search=40)[1], gt, 10)
    assert got >= want - 0.02, (codes, got, want)
    assert getattr(pt.graph, {"packed": "packed", "sq": "sq_codes", "pq": "pq_codes"}[codes]) \
        is not None


def test_adj_width_and_checkpoint_resume(data, port_shards, tmp_path, monkeypatch):
    x, q, gt = data
    port_shards.patch(monkeypatch, GraphIndex)
    kw = dict(MERGED, adj_width=10, checkpoint_dir=str(tmp_path / "ck"), device=CPU)
    pt = build_merged(x, GraphConfig(**CFG), **kw)
    adj = n(pt.graph.state.adjacency)[:N]
    assert adj.shape[1] == 10
    np.testing.assert_array_equal(n(pt.graph.state.degrees)[:N], (adj >= 0).sum(1))
    assert knn_recall(pt.search(q, 10, l_search=40)[1], gt, 10) >= 0.85
    assert len((tmp_path / "ck" / "shards_done.txt").read_text().split()) == 3
    # every shard is recorded done: the rerun skips every build and
    # assembles the same adjacency from the memmapped merge state
    asked = port_shards.requests
    again = build_merged(x, GraphConfig(**CFG), **kw)
    assert port_shards.requests == asked
    np.testing.assert_array_equal(n(again.graph.state.adjacency)[:N], adj)


def test_single_shard_delegates(data):
    x, _, _ = data
    pt = build_merged(x[:600], GraphConfig(**CFG), n_shards=1, dp=16,
                      insert_batch_size=256, device=CPU)
    assert pt.graph._hbm_vectors_dropped and pt.graph.packed is not None
    assert pt.graph.state.capacity == 768      # the build's, not the merge's
    _, ids, _ = pt.search(x[:5] + 0.01, k=1, l_search=24)
    assert (ids[:, 0] == np.arange(5)).mean() >= 0.8


def test_kmeans_partition_and_shard_lists(data):
    x, _, _ = data
    centers, assign = kmeans_partition(x, 4, overlap=2, seed=1, device=CPU)
    assert centers.shape == (4, D) and assign.shape == (N, 2) and assign.dtype == np.int64
    d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(assign[:, 0], d.argmin(1))
    lists = shard_lists(assign, 4)
    assert sum(len(s) for s in lists) == 2 * N
    for s, rows in enumerate(lists):
        assert (assign[rows] == s).any(1).all()


# --------------------------------------------- dropped vectors and stores
def test_dropped_vectors_keep_the_guards(data, jax_tiered):
    x, q, _ = data
    g = _carry(jax_tiered, x).graph
    start = n(g._start()).copy()
    np.testing.assert_array_equal(start, np.asarray(jax_tiered.graph._cached_start))
    with pytest.raises(ValueError, match="random_vectors"):
        g.set_start_strategy("random_vectors")
    with pytest.raises(ValueError, match="visited_topk"):
        g.delete(np.array([5]), method="visited_topk")
    assert g.n_deleted == 0 and bool(g.state.valid[5])    # nothing was marked
    g._invalidate_start()
    np.testing.assert_array_equal(n(g._start()), start)   # pinned
    # routing: the router scores packed rows; full mode does not route
    assert g._router_ids_live("full") is None and g._router_ids_live("packed") is not None
    assert g._packed_router("full")


def test_filtered_on_dropped_vectors_skips_the_scan(data, jax_tiered, monkeypatch):
    """Without the full vectors there is no posting-list scan: the
    predicate count is never taken (the reference's guard), and a
    predicate under the scan threshold walks."""
    x, q, _ = data
    g = _carry(jax_tiered, x).graph
    monkeypatch.setattr(GraphIndex, "_predicate_count",
                        lambda *a: (_ for _ in ()).throw(AssertionError("counted")))
    _, _, st = g.search_filtered(q, "hot", 10, l_search=32, mode="packed",
                                 scan_threshold=N)
    assert (st.hops > 0).all()


def test_sqlite_store_plugs_in(data, tmp_path):
    x, q, _ = data
    g = GraphIndex.build(x[:1000], GraphConfig(**CFG), insert_batch_size=512, device=CPU)
    g.attach_packed(dp=16)
    store = SqliteVectorStore.from_array(str(tmp_path / "v.db"), x[:1000])
    assert store.n == 1000 and store.dim == D
    ti, ti_ram = TieredIndex(g, store), TieredIndex(g, HostVectorStore(x[:1000]))
    d1, i1, _ = ti.search(q, 5, l_search=24)
    d2, i2, _ = ti_ram.search(q, 5, l_search=24)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5)
    np.testing.assert_array_equal(ti.search_batched(q, 5, l_search=24, batch_size=8)[1], i2)
    store.put(np.array([0]), np.full((1, D), 9.0, np.float32))
    np.testing.assert_allclose(store.fetch(np.array([0]))[0], 9.0)
    store.close()
