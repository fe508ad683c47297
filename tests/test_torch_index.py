"""The port's main path end to end, against the JAX package's.

n=2048 x 32 clustered data, R=16, L=32, W=4, batch 512, packed build at
dp=32, `attach_packed(dp=32)`, packed search with the router on (S=512,
so both packages pick entry points exactly).  The port builds its own
graph: its recall@10 must be within 0.02 of the JAX package's and its
graph must keep the index invariants.  A JAX-built index carried across by
`convert.py` must return the same ids as the JAX search for >= 99% of the
(query, rank) entries (the float32 query projection may round one int8
query code differently).  One more insert batch on a carried-across index
must leave the same graph and fat-row table as the JAX insert, bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diskann_tpu import FlatIndex as JFlat
from diskann_tpu import GraphConfig as JConfig
from diskann_tpu import GraphIndex as JIndex
from diskann_tpu import Metric as JMetric
from diskann_tpu.graph import packed as jpk
from diskann_tpu.graph.state import start_ids as j_start_ids
from diskann_tpu.graph.index import _filter_deleted as j_filter_deleted
from diskann_tpu_torch import FlatIndex, GraphConfig, GraphIndex, Metric
from diskann_tpu_torch.bench.harness import make_clustered
from diskann_tpu_torch.bench.recall import knn_recall
from diskann_tpu_torch.convert import graph_index_from_arrays
from diskann_tpu_torch.graph import packed as tpk
from diskann_tpu_torch.graph import state as tpk_state
from diskann_tpu_torch.graph.index import _filter_deleted
from torch_port_helpers import CPU, jax_index_arrays, n, t

N, D, NQ, K, L = 2048, 32, 256, 10, 32
CFG = dict(max_degree=16, l_build=32, beam_width=4)


@pytest.fixture(scope="module")
def data():
    x, q = make_clustered(11, N, NQ, D, n_clusters=64, sigma=0.35)
    _, gt = FlatIndex(x, device=CPU).search(q, K)
    return x, q, gt


@pytest.fixture(scope="module")
def jax_index(data):
    x, _, _ = data
    idx = JIndex.build(x, JConfig(**CFG), insert_batch_size=512,
                       build_mode="packed", packed_dp=32)
    idx.attach_packed(dp=32)
    return idx


@pytest.fixture(scope="module")
def torch_index(data):
    x, _, _ = data
    idx = GraphIndex.build(x, GraphConfig(**CFG), insert_batch_size=512,
                           build_mode="packed", packed_dp=32, device=CPU)
    # the build-time table, before the re-attach replaces it
    refreshed = tpk.refresh_rows(
        tpk.PackedState(**{**idx.packed.__dict__, "rows": idx.packed.rows.clone()}),
        idx.state.adjacency, torch.arange(idx.n),
    )
    build_table = (idx.packed.rows.clone(), refreshed.rows)
    idx.attach_packed(dp=32)
    return idx, build_table


def _check_invariants(idx, packed=None):
    packed = packed or idx.packed
    adj = n(idx.state.adjacency)[: idx.n]
    deg = n(idx.state.degrees)[: idx.n]
    assert adj.dtype == np.int32
    filled = adj >= 0
    np.testing.assert_array_equal(filled.sum(1), deg)
    # -1 padding: every row is its neighbours, then -1s
    np.testing.assert_array_equal(filled, np.arange(adj.shape[1])[None, :] < deg[:, None])
    assert not (adj == np.arange(idx.n)[:, None]).any(), "self-loop"
    for row, d in zip(adj, deg):
        assert len(np.unique(row[:d])) == d, "duplicate neighbour"
    assert (deg <= idx.config.max_degree_with_slack).all()
    # the packed id section mirrors adjacency
    fat = n(packed.rows).reshape(-1, packed.nwr * 128)[: idx.n]
    np.testing.assert_array_equal(fat[:, : adj.shape[1]], adj)


def test_flat_index_matches_jax(data):
    x, q, gt = data
    _, jgt = JFlat(x).search(q, K)
    np.testing.assert_array_equal(gt, np.asarray(jgt))


def test_port_build_keeps_graph_invariants(torch_index):
    idx, (table, refreshed) = torch_index
    _check_invariants(idx)
    # the incrementally maintained build table equals a full refresh
    live = idx.n * idx.packed.nwr
    assert torch.equal(table[:live], refreshed[:live])


def test_port_recall_close_to_jax(data, jax_index, torch_index):
    _, q, gt = data
    idx, _ = torch_index
    kw = dict(l_search=L, beam_width=4, mode="packed")
    _, jids, _ = jax_index.search(q, K, **kw)
    _, tids, tstats = idx.search(q, K, **kw)
    jr, tr = knn_recall(jids, gt, K), knn_recall(tids, gt, K)
    assert tr >= jr - 0.02, (tr, jr)
    assert tr >= 0.9
    assert tids.shape == (NQ, K) and tstats.hops.shape == (NQ,)


def test_converted_index_search_matches_jax(data, jax_index):
    _, q, _ = data
    tidx = graph_index_from_arrays(**jax_index_arrays(jax_index))
    _check_invariants(tidx)
    kw = dict(l_search=L, beam_width=4, mode="packed", rerank_l=12, max_hops=6)
    jd, jids, _ = jax_index.search(q, K, **kw)
    td, tids, _ = tidx.search(q, K, **kw)
    share = (tids == np.asarray(jids)).mean()
    print(f"identical (query, rank) ids: {share:.4f}")
    assert share >= 0.99
    same = tids == np.asarray(jids)
    np.testing.assert_allclose(td[same], np.asarray(jd)[same], rtol=1e-5, atol=1e-5)


def test_bf16_router_search(data, torch_index):
    _, q, gt = data
    idx, _ = torch_index
    idx.router_compute = "bf16"
    try:
        _, ids, _ = idx.search(q, K, l_search=24, beam_width=4, mode="packed",
                               rerank_l=12, max_hops=6)
    finally:
        idx.router_compute = "int8"
    assert knn_recall(ids, gt, K) >= 0.9


def test_routed_build_keeps_invariants():
    # router_size=64 starts the build-time router after 256 committed rows
    x, q = make_clustered(5, 1024, 64, 16, n_clusters=32, sigma=0.35)
    idx = GraphIndex.build(x, GraphConfig(max_degree=12, l_build=24, beam_width=4,
                                          router_size=64),
                           insert_batch_size=256, build_mode="packed",
                           packed_dp=16, device=CPU)
    _check_invariants(idx)
    _, gt = FlatIndex(x, device=CPU).search(q, K)
    _, ids, _ = idx.search(q, K, l_search=24, beam_width=4, mode="packed")
    assert knn_recall(ids, gt, K) >= 0.9


def test_unported_modes_raise(torch_index):
    # the quantized modes are ported now: without their attachment they
    # ask for it; mode="auto" is ported (a small index takes the flat scan)
    # and an unknown mode raises; so does a query wire neither package has
    # (the int8 wire is ported: `test_torch_filters.py`)
    idx, _ = torch_index
    with pytest.raises(ValueError, match="attach_pq"):
        idx.search(np.zeros((1, D), np.float32), K, mode="pq")
    assert (idx.search(np.zeros((1, D), np.float32), K, mode="auto")[2].hops == 0).all()
    with pytest.raises(ValueError, match="unknown search mode"):
        idx.search(np.zeros((1, D), np.float32), K, mode="nope")
    with pytest.raises(NotImplementedError):
        idx.search(np.zeros((1, D), np.float32), K, mode="packed", query_dtype=np.int16)
    with pytest.raises(ValueError):
        GraphIndex.build(np.zeros((8, D), np.float32), build_mode="pq", device=CPU)


def test_len_is_the_live_count_like_jax(jax_index):
    tidx = graph_index_from_arrays(**jax_index_arrays(jax_index))
    assert len(tidx) == len(jax_index) == tidx.n_live == N
    tidx.delete(np.arange(0, 300, 3))
    assert len(tidx) == N - 100
    # an empty index has length 0 and is falsy, in both packages
    assert len(GraphIndex(D, device=CPU)) == len(JIndex(D)) == 0
    assert not GraphIndex(D, device=CPU)


def test_attach_packed_takes_the_reference_options(data, jax_index):
    # writable and spill change nothing; refresh_block only chunks the
    # refresh: every option gives the table of the default call, and that
    # table has JAX's ids and codes (the codes within encode's rounding)
    _, q, _ = data
    tidx = graph_index_from_arrays(**jax_index_arrays(jax_index))
    tidx.attach_packed(dp=32)
    default = tidx.packed.rows.clone()
    want = tidx.search(q, K, l_search=L, beam_width=4, mode="packed")
    tidx.attach_packed(dp=32, writable=False, refresh_block=300, spill=True)
    assert torch.equal(tidx.packed.rows, default)
    got = tidx.search(q, K, l_search=L, beam_width=4, mode="packed")
    np.testing.assert_array_equal(got[1], want[1])
    jrows = np.asarray(jpk.logical_rows(jax_index.packed))
    trows = n(tpk.logical_rows(tidx.packed))
    off = tidx.packed.aux_off_w
    np.testing.assert_array_equal(trows[:N, :off], jrows[:N, :off])
    codes_t, codes_j = n(tidx.packed.self_codes), np.asarray(jax_index.packed.self_codes)
    diff = codes_t.astype(np.int32) - codes_j
    assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= 1e-3


def test_filter_deleted_matches_jax():
    rng = np.random.default_rng(2)
    ids = rng.integers(-1, 50, size=(6, 12)).astype(np.int32)
    dists = np.sort(rng.random((6, 12)).astype(np.float32), axis=1)
    valid = rng.random(50) > 0.3
    want = j_filter_deleted(jnp.asarray(dists), jnp.asarray(ids), jnp.asarray(valid), 5)
    got = _filter_deleted(t(dists), t(ids), t(valid), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))


def test_insert_grows_capacity_and_keeps_invariants():
    # a second insert call past the capacity grows the graph and the packed
    # table (the old dump row is dropped, a new one appended)
    x, q = make_clustered(6, 1400, 64, 16, n_clusters=32, sigma=0.35)
    idx = GraphIndex.build(x[:1000], GraphConfig(max_degree=12, l_build=24,
                                                 beam_width=4, router_size=0),
                           insert_batch_size=256, build_mode="packed",
                           packed_dp=16, device=CPU)
    cap0 = idx.state.capacity
    slots = idx.insert(x[1000:])
    np.testing.assert_array_equal(slots, np.arange(1000, 1400))
    assert idx.n == 1400 and idx.state.capacity > cap0
    assert idx.packed.rows.shape[0] == (idx.state.capacity + 1) * idx.packed.nwr
    _check_invariants(idx)
    _, gt = FlatIndex(x, device=CPU).search(q, K)
    _, ids, _ = idx.search(q, K, l_search=24, beam_width=4, mode="packed")
    assert knn_recall(ids, gt, K) >= 0.9


def test_insert_batch_after_convert_matches_jax(monkeypatch):
    # A JAX index after six batches, carried across; then one more batch on
    # both sides.  Router off and M <= 2 x max_occlusion_size keep JAX exact
    # (no approx_min_k); the new rows' int8 codes are JAX's own, since the
    # float32 projection may round a code differently.  Phases 1-3c must
    # then leave the same graph and the same fat-row table.
    x, _ = make_clustered(8, 1792, 8, D, n_clusters=32, sigma=0.35)
    base, new = x[:1536], x[1536:]
    cfg = dict(max_degree=12, l_build=24, beam_width=4, router_size=0)
    jidx = JIndex.build(base, JConfig(**cfg), insert_batch_size=256,
                        build_mode="packed", packed_dp=32, capacity=2048)
    tidx = graph_index_from_arrays(**jax_index_arrays(jidx), insert_batch_size=256)
    # the insert call starts from the medoid of all 1536 rows on both sides
    jidx._invalidate_start()
    assert n(tidx._start()).tolist() == np.asarray(jidx._start()).tolist()

    jidx.insert(new)
    jcodes = np.asarray(jidx.packed.self_codes)[1536:1792]
    jaux = np.asarray(jidx.packed.self_aux)[1536:1792]
    monkeypatch.setattr(tpk, "encode", lambda *a: (t(jcodes), t(jaux)))
    old_adj, old_deg = n(tidx.state.adjacency)[:1536].copy(), n(tidx.state.degrees)[:1536].copy()
    tidx.insert(new)
    assert tidx.state.capacity == jidx.state.capacity == 2048
    jadj, tadj = np.asarray(jidx.state.adjacency), n(tidx.state.adjacency)
    # phases 3b and 3c both ran: old rows gained backedges, and some were
    # re-pruned (no longer their old row followed by appended sources)
    cols = np.arange(old_adj.shape[1])[None, :] < old_deg[:, None]
    kept_prefix = ((tadj[:1536] == old_adj) | ~cols).all(1)
    assert (n(tidx.state.degrees)[:1536] > old_deg).any()
    assert (~kept_prefix).sum() > 0
    print(f"identical adjacency rows: {(jadj == tadj).all(1).mean():.4f}")
    np.testing.assert_array_equal(tadj, jadj)
    np.testing.assert_array_equal(n(tidx.state.degrees), np.asarray(jidx.state.degrees))
    np.testing.assert_array_equal(n(tidx.state.vectors), np.asarray(jidx.state.vectors))
    np.testing.assert_array_equal(n(tidx.packed.self_codes),
                                  np.asarray(jidx.packed.self_codes))
    live = tidx.n * tidx.packed.nwr
    np.testing.assert_array_equal(n(tidx.packed.rows)[:live],
                                  np.asarray(jidx.packed.rows)[:live])
    _check_invariants(tidx)


def test_convert_rejects_mismatched_arrays(jax_index):
    arrays = jax_index_arrays(jax_index)
    bad_cfg = dict(arrays, config={**arrays["config"], "max_degree": 20})
    with pytest.raises(ValueError):
        graph_index_from_arrays(**bad_cfg)
    packed = dict(arrays["packed"], rows=arrays["packed"]["rows"][:-8])
    with pytest.raises(ValueError):
        graph_index_from_arrays(**dict(arrays, packed=packed))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_full_build_matches_jax(metric):
    # build_mode="full" (the default): the full-precision walk and a prune
    # on its distances.  Batch 256 <= 2 x max_occlusion_size keeps JAX's
    # intra-batch candidates exact (no approx_min_k), so the graphs agree.
    x, _ = make_clustered(12, 1100, 8, 16, n_clusters=32, sigma=0.35)
    cfg = dict(max_degree=12, l_build=24, beam_width=4, metric=JMetric(metric))
    jidx = JIndex.build(x, JConfig(**cfg), insert_batch_size=256)
    tidx = GraphIndex.build(x, GraphConfig(**{**cfg, "metric": Metric(metric)}),
                            insert_batch_size=256, device=CPU)
    assert tidx.packed is None and tidx.n == jidx.n == 1100
    np.testing.assert_array_equal(n(tidx.state.adjacency), np.asarray(jidx.state.adjacency))
    np.testing.assert_array_equal(n(tidx.state.degrees), np.asarray(jidx.state.degrees))
    assert tidx.last_insert_stats == jidx.last_insert_stats
    _check_invariants_full(tidx)


def _check_invariants_full(idx):
    adj = n(idx.state.adjacency)[: idx.n]
    deg = n(idx.state.degrees)[: idx.n]
    np.testing.assert_array_equal((adj >= 0).sum(1), deg)
    assert not (adj == np.arange(idx.n)[:, None]).any()


@pytest.mark.parametrize("strategy,k", [
    ("medoid", 1), ("first_vector", 1), ("random_samples", 5),
    ("latin_hypercube", 6), ("random_vectors", 4),
])
def test_start_ids_match_jax(data, jax_index, strategy, k):
    tidx = graph_index_from_arrays(**jax_index_arrays(jax_index))
    # deleted slots are skipped by every strategy
    valid = np.asarray(jax_index.state.valid).copy()
    valid[[0, 3, 700]] = False
    jst = jax_index.state._replace(valid=jnp.asarray(valid))
    tidx.state.valid[[0, 3, 700]] = False
    want = np.asarray(j_start_ids(jst, N, strategy, k, seed=9))
    got = n(tpk_state.start_ids(tidx.state, N, strategy, k, seed=9))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert valid[got].all()


def test_set_start_strategy_drives_the_walk(jax_index):
    tidx = graph_index_from_arrays(**jax_index_arrays(jax_index))
    tidx.set_start_strategy("random_samples", k=3, seed=4)
    jax_index.set_start_strategy("random_samples", k=3, seed=4)
    try:
        np.testing.assert_array_equal(n(tidx._start()), np.asarray(jax_index._start()))
    finally:
        jax_index.set_start_strategy("medoid")
    assert tidx._start().shape == (3,)
    with pytest.raises(ValueError):
        tidx.set_start_strategy("nearest_cluster")
