"""The port's label filtering against the JAX package's.

- The copied predicate parser, the int32 label bitset and the compiled
  accept masks, bitwise.
- The full-precision inline filter walk (ring dedup, W=1) and the plain
  ring walk, exactly against the scalar oracles of `reference_impl`: the
  same matched ids, navigation ids and ``cmps``.
- `search_filtered` end to end on one JAX-built packed index (n=2048 x 16,
  R=16, router on with S=512 so both packages take exact top-k), carried
  across by `convert.py` with its labels: the scan, the packed walk with
  its compact AdaptiveL retry, the full inline walk with AdaptiveL resume,
  multihop, `search(mode="full")` and float16 queries; the packed walk
  with the queries through the int8 wire (every name of it) and through
  bfloat16; the reference's full route with the int8 wire, which
  truncates the queries, against the port's, which takes the wire
  (`test_reference_fault_i8_wire_full_route`).  The float32
  products of the two frameworks sum in different orders, so near-tied
  distances may swap: each path must give identical ids for >= 99% of
  (query, rank) entries, and equal ids must carry equal distances within
  rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diskann_tpu import GraphConfig as JConfig, GraphIndex as JIndex, Metric as JMetric
from diskann_tpu.filters import LabelSet as JLabelSet
from diskann_tpu.filters import compile_accept as j_compile_accept
from diskann_tpu.filters import parse_predicate as j_parse
from diskann_tpu.graph.scorers import full_precision_scorer as j_fp_scorer
from diskann_tpu.graph.search import beam_search_scored as j_search
from diskann_tpu_torch.bench.harness import make_clustered
from diskann_tpu_torch.convert import graph_index_from_arrays
from diskann_tpu_torch.filters import LabelSet, compile_accept, parse_predicate
from diskann_tpu_torch.graph import index as tindex
from diskann_tpu_torch.graph.scorers import full_precision_scorer
from diskann_tpu_torch.graph.search import beam_search_scored
from diskann_tpu_torch.ops.distance import Metric
from reference_impl import greedy_filter_search, greedy_search
from torch_port_helpers import jax_index_arrays, n, t

N, D, NQ, K = 2048, 16, 96, 10


# ----------------------------------------------------------- predicate + bits
@pytest.mark.parametrize("expr", [
    "a & (b | !c)", "x", "a AND b OR c", "NOT a | (b & ~c)",
    "tag.1:x-y & !(p OR q)", "((a))",
])
def test_predicate_copy_parses_like_jax(expr):
    assert repr(parse_predicate(expr)) == repr(j_parse(expr))


@pytest.mark.parametrize("expr", ["a &", "(a", "a b", "| a", "", "!(a | b"])
def test_predicate_copy_rejects_like_jax(expr):
    # an unclosed parenthesis at the end of the input escapes the
    # reference's parser as an IndexError; the copy raises ValueError
    with pytest.raises((ValueError, IndexError)):
        j_parse(expr)
    with pytest.raises(ValueError):
        parse_predicate(expr)


def _random_labels(rng, n_points, n_labels, per_point=3):
    return [[f"l{c}" for c in rng.choice(n_labels, size=rng.integers(0, per_point + 1),
                                         replace=False)]
            for _ in range(n_points)]


def test_labelset_bits_match_jax():
    rng = np.random.default_rng(3)
    labels = _random_labels(rng, 300, 70)       # 3 words: bit 31 is the sign bit
    jls = JLabelSet.from_lists(labels, capacity=320)
    tls = LabelSet.from_lists(labels, capacity=320)
    assert tls.vocab == jls.vocab and tls.n_words == jls.n_words == 3
    assert tls.bits.dtype == torch.int32
    np.testing.assert_array_equal(n(tls.bits), np.asarray(jls.bits).view(np.int32))
    ids = np.array([0, 5, 299, 319, -1, 400, 17], np.int32)
    for label in ("l0", "l31", "l32", "l63", "l69"):
        np.testing.assert_array_equal(tls.members(label), jls.members(label))
        np.testing.assert_array_equal(n(tls.test(label, t(ids))),
                                      np.asarray(jls.test(label, jnp.asarray(ids))))


def test_labelset_word_growth_matches_jax():
    # the YFCC-scale case of test_filters.py: 500 labels past the initial
    # word budget, then set_labels with 40 new labels grows the words mid-call
    rng = np.random.default_rng(0xD15CA)
    labels = [[f"tag{x}" for x in rng.choice(500, size=3, replace=False)]
              for _ in range(600)]
    jls = JLabelSet.from_lists(labels, capacity=1024)
    tls = LabelSet.from_lists(labels, capacity=1024)
    new = [[f"new{x}" for x in range(40)], ["tag0", "new0"]]
    jls.set_labels(np.array([600, 601]), new)
    tls.set_labels(np.array([600, 601]), new)
    assert tls.n_words == jls.n_words and tls.vocab == jls.vocab
    assert tls.version == jls.version == 1
    np.testing.assert_array_equal(n(tls.bits), np.asarray(jls.bits).view(np.int32))
    for label in ("new39", "new0", "tag0", labels[17][0]):
        np.testing.assert_array_equal(tls.members(label), jls.members(label))


@pytest.mark.parametrize("expr", ["l0", "l0 & l1", "l1 | l40", "!(l0 | l2) & l39",
                                  "l0 & !l33 | l3", "!l5"])
def test_compile_accept_matches_jax(expr):
    rng = np.random.default_rng(len(expr))
    labels = _random_labels(rng, 200, 41)
    cap = 256
    jls = JLabelSet.from_lists(labels, capacity=cap)
    tls = LabelSet.from_lists(labels, capacity=cap)
    ids = rng.integers(-3, cap + 5, size=(7, 60)).astype(np.int32)
    ids[:, 0] = -1
    valid = rng.random((7, 60)) < 0.8
    jfn = j_compile_accept(j_parse(expr), jls.vocab, cap)
    tfn = compile_accept(parse_predicate(expr), tls.vocab, cap)
    want = np.asarray(jfn(jls.bits, jnp.asarray(ids), jnp.asarray(valid)))
    got = n(tfn(tls.bits, t(ids), t(valid)))
    np.testing.assert_array_equal(got, want)
    assert not got[:, 0].any()
    # the AST's own evaluation over a LabelSet agrees too
    want_ev = np.asarray(j_parse(expr).evaluate(jls, jnp.asarray(ids), jnp.asarray(valid)))
    got_ev = n(parse_predicate(expr).evaluate(tls, t(ids), t(valid)))
    np.testing.assert_array_equal(got_ev, want_ev)


# ----------------------------------------------------------- scalar oracles
def _oracle_graph(seed):
    rng = np.random.default_rng(seed)
    nn, d, r = 200, 8, 6
    vectors = rng.standard_normal((nn, d)).astype(np.float32)
    adj = np.full((nn, r), -1, np.int32)
    for i in range(nn):
        ch = rng.choice(nn - 1, size=r, replace=False)
        ch[ch >= i] += 1
        adj[i] = ch
    hot = rng.random(nn) < 0.3
    hot[0] = True
    queries = rng.standard_normal((4, d)).astype(np.float32)
    return vectors, adj, hot, queries


@pytest.mark.parametrize("seed", [0xD15CA, 5])
def test_inline_filter_matches_scalar_oracle_and_jax(seed):
    vectors, adj, hot, queries = _oracle_graph(seed)
    l = 12
    labels = [["hot"] if h else ["cold"] for h in hot]
    kw = dict(l_search=l, beam_width=1, max_hops=4096, history_capacity=16384,
              filter_beta=0.5, filter_mode="inline")
    jls = JLabelSet.from_lists(labels, capacity=len(hot))
    jdef, jdata = j_fp_scorer(jnp.asarray(vectors),
                              jnp.asarray((vectors * vectors).sum(1)),
                              JMetric.L2)
    want = j_search(jdef, jdata, jnp.asarray(adj), jnp.zeros((1,), jnp.int32),
                    jnp.asarray(queries),
                    accept_fn=j_compile_accept(j_parse("hot"), jls.vocab, len(hot)),
                    accept_data=jls.bits, **kw)
    tls = LabelSet.from_lists(labels, capacity=len(hot))
    tdef, tdata = full_precision_scorer(t(vectors), t((vectors * vectors).sum(1)),
                                        Metric.L2)
    got = beam_search_scored(
        tdef, tdata, t(adj), torch.zeros(1, dtype=torch.int32), t(queries),
        accept_fn=compile_accept(parse_predicate("hot"), tls.vocab, len(hot)),
        accept_data=tls.bits, **kw)
    for f in ("match_i", "ids", "cmps", "hops"):
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)))
    for b in range(len(queries)):
        want_m, want_nav, want_cmps = greedy_filter_search(
            vectors, adj, [0], queries[b], l, lambda i: hot[i], beta=0.5)
        assert [int(i) for i in got.match_i[b] if i >= 0] == want_m
        assert [int(i) for i in got.ids[b] if i >= 0] == want_nav
        assert int(got.cmps[b]) == want_cmps


@pytest.mark.parametrize("seed", [0xD15CA, 5])
def test_ring_search_matches_greedy_search(seed):
    vectors, adj, _, queries = _oracle_graph(seed)
    tdef, tdata = full_precision_scorer(t(vectors), t((vectors * vectors).sum(1)),
                                        Metric.L2)
    got = beam_search_scored(tdef, tdata, t(adj), torch.tensor([0, 7], dtype=torch.int32),
                             t(queries), l_search=10, beam_width=1, max_hops=4096,
                             history_capacity=16384, dedup="ring")
    for b in range(len(queries)):
        want_ids, want_cmps = greedy_search(vectors, adj, [0, 7], queries[b], 10)
        assert [int(i) for i in got.ids[b] if i >= 0] == want_ids
        assert int(got.cmps[b]) == want_cmps


# ------------------------------------------------------- end to end vs JAX
def _labels(nn):
    rng = np.random.default_rng(17)
    red = rng.random(nn) < 0.4
    hot = rng.random(nn) < 0.04
    rare = rng.random(nn) < 0.012
    rare[:3] = True
    return [(["red"] if r else ["blue"]) + (["hot"] if h else [])
            + (["rare"] if s else []) for r, h, s in zip(red, hot, rare)]


@pytest.fixture(scope="module")
def indices():
    x, q = make_clustered(23, N, NQ, D, n_clusters=48, sigma=0.35)
    jidx = JIndex.build(x, JConfig(max_degree=16, l_build=32, beam_width=4),
                        insert_batch_size=512, build_mode="packed", packed_dp=16)
    labels = _labels(N)
    jidx.attach_labels(labels)
    # the build caches the medoid of its first batches; both packages start
    # the full route from the medoid of all rows
    jidx._invalidate_start()
    tidx = graph_index_from_arrays(**jax_index_arrays(jidx))
    assert n(tidx._start()).tolist() == np.asarray(jidx._start()).tolist()
    return jidx, tidx, q, labels


def _same(want, got, min_share=0.99):
    (jd, ji, js), (td, ti, ts) = want, got
    ji, jd = np.asarray(ji), np.asarray(jd)
    assert ti.shape == ji.shape
    same = ti == ji
    print(f"identical (query, rank) ids: {same.mean():.4f}")
    assert same.mean() >= min_share
    ok = same & (ji >= 0)
    np.testing.assert_allclose(td[ok], jd[ok], rtol=1e-5, atol=1e-5)
    return same


def _honours(ids, labels, label):
    got = ids[ids >= 0]
    assert got.size > 0 and all(label in labels[i] for i in got)
    for row in ids:
        live = row[row >= 0]
        assert len(live) == len(set(live.tolist())), row


def test_label_carry_across(indices):
    jidx, tidx, _, _ = indices
    assert tidx.labels.vocab == jidx.labels.vocab
    np.testing.assert_array_equal(n(tidx.labels.bits),
                                  np.asarray(jidx.labels.bits).view(np.int32))


def test_scan_route_matches_jax(indices):
    jidx, tidx, q, labels = indices
    want = jidx.search_filtered(q, "rare", K)
    got = tidx.search_filtered(q, "rare", K)
    _same(want, got)
    cnt = sum("rare" in ls for ls in labels)
    assert (got[2].cmps == cnt).all() and (got[2].hops == 0).all()
    np.testing.assert_array_equal(got[2].cmps, want[2].cmps)
    _honours(got[1], labels, "rare")


@pytest.mark.parametrize("query_dtype", [None, np.float16])
def test_packed_walk_matches_jax(indices, query_dtype):
    jidx, tidx, q, labels = indices
    kw = dict(l_search=32, mode="packed", scan_threshold=0, max_hops=16,
              query_dtype=query_dtype)
    want = jidx.search_filtered(q, "red", K, **kw)
    got = tidx.search_filtered(q, "red", K, **kw)
    _same(want, got)
    assert (got[2].hops > 0).all()
    _honours(got[1], labels, "red")


def test_packed_compact_retry_matches_jax(indices, monkeypatch):
    jidx, tidx, q, labels = indices
    kw = dict(l_search=32, mode="packed", scan_threshold=0)
    _, fi0, _ = tidx.search_filtered(q, "rare", 5, adaptive_l=False, **kw)
    short = (fi0 >= 0).sum(1) < 5
    assert 0 < short.sum() < len(q), "fixture no longer gives short queries"
    calls = []
    orig = tindex.GraphIndex._filtered_packed_batch

    def spy(self, qb, accept_fn, k, l, *a):
        calls.append((l, qb.shape[0]))
        return orig(self, qb, accept_fn, k, l, *a)

    monkeypatch.setattr(tindex.GraphIndex, "_filtered_packed_batch", spy)
    got = tidx.search_filtered(q, "rare", 5, **kw)
    ls = sorted({c[0] for c in calls})
    assert len(ls) == 2, calls
    assert sum(r for l, r in calls if l == ls[0]) == len(q)
    assert sum(r for l, r in calls if l == ls[1]) == short.sum()
    np.testing.assert_array_equal(got[1][~short], fi0[~short])
    assert ((got[1] >= 0).sum(1) >= (fi0 >= 0).sum(1)).all()
    want = jidx.search_filtered(q, "rare", 5, **kw)
    _same(want, got)
    _honours(got[1], labels, "rare")


def test_full_inline_adaptive_resume_matches_jax(indices):
    jidx, tidx, q, labels = indices
    kw = dict(l_search=12, scan_threshold=0)
    _, fi0, s0 = tidx.search_filtered(q, "hot", K, adaptive_l=False, **kw)
    f0 = (fi0 >= 0).sum(1)
    assert (f0 < K).any(), "fixture no longer triggers the resume"
    want = jidx.search_filtered(q, "hot", K, **kw)
    got = tidx.search_filtered(q, "hot", K, **kw)
    _same(want, got)
    f1 = (got[1] >= 0).sum(1)
    assert (f1 >= f0).all() and f1.sum() > f0.sum()
    assert got[2].cmps.sum() > s0.cmps.sum() and got[2].hops.sum() > s0.hops.sum()
    np.testing.assert_array_equal(got[2].cmps, np.asarray(want[2].cmps))
    _honours(got[1], labels, "hot")


def test_multihop_matches_jax(indices):
    jidx, tidx, q, labels = indices
    kw = dict(l_search=32, method="multihop")
    want = jidx.search_filtered(q, "hot", K, **kw)
    got = tidx.search_filtered(q, "hot", K, **kw)
    _same(want, got)
    _honours(got[1], labels, "hot")


@pytest.mark.parametrize("query_dtype", [None, np.float16])
def test_full_search_matches_jax(indices, query_dtype):
    jidx, tidx, q, _ = indices
    kw = dict(l_search=32, beam_width=4, mode="full", query_dtype=query_dtype)
    want = jidx.search(q, K, **kw)
    got = tidx.search(q, K, **kw)
    _same(want, got)
    np.testing.assert_array_equal(got[2].hops, np.asarray(want[2].hops))


def test_packed_search_query_dtype_matches_jax(indices):
    jidx, tidx, q, _ = indices
    kw = dict(l_search=24, beam_width=4, mode="packed", query_dtype=np.float16)
    _same(jidx.search(q, K, **kw), tidx.search(q, K, **kw))


@pytest.mark.parametrize("wire", ["i8", "int8", "i8pack", np.int8, "bfloat16"])
def test_packed_search_query_wire_matches_jax(indices, wire):
    jidx, tidx, q, _ = indices
    kw = dict(l_search=24, beam_width=4, mode="packed")
    want = jidx.search(q, K, query_dtype=jnp.bfloat16 if wire == "bfloat16" else wire, **kw)
    got = tidx.search(q, K, query_dtype=wire, **kw)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5, atol=1e-5)


def test_reference_fault_i8_wire_full_route(indices):
    """The reference's full route casts the queries to ``query_dtype``:
    "i8" is int64 to numpy and "int8" int8, so both truncate the queries
    to integers, and "i8pack" raises.  The port's full route takes the
    int8 wire, as both packages' quantized routes do."""
    from diskann_tpu.graph.index import _decode_i8pack as j_decode
    from diskann_tpu.graph.index import _encode_i8pack as j_encode

    jidx, tidx, q, _ = indices
    kw = dict(l_search=32, beam_width=4, mode="full")
    truncated = q.astype(np.int64).astype(np.float32)
    for name in ("i8", "int8"):
        np.testing.assert_array_equal(np.asarray(jidx.search(q, K, query_dtype=name, **kw)[1]),
                                      np.asarray(jidx.search(truncated, K, **kw)[1]))
    with pytest.raises(TypeError):
        jidx.search(q, K, query_dtype="i8pack", **kw)
    wired = np.array(j_decode(jnp.asarray(j_encode(q)), D))
    for name in ("i8", "int8", "i8pack"):
        got = tidx.search(q, K, query_dtype=name, **kw)
        want = tidx.search(wired, K, **kw)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        _same(jidx.search(wired, K, **kw), got)
    # the fault changes the answers: the truncated queries find other points
    assert (got[1] != np.asarray(jidx.search(q, K, query_dtype="i8", **kw)[1])).mean() > 0.5


def test_i8_wire_copy_matches_jax():
    from diskann_tpu.graph.index import _decode_i8pack as j_decode
    from diskann_tpu.graph.index import _encode_i8pack as j_encode

    rng = np.random.default_rng(4)
    q = rng.standard_normal((64, 20)).astype(np.float32) * rng.uniform(0.01, 50, (64, 1))
    q[3] = 0.0                                      # an all-zero row: the 1e-12 floor
    wire = tindex._encode_i8pack(q)
    np.testing.assert_array_equal(wire, j_encode(q))
    np.testing.assert_array_equal(n(tindex._decode_i8pack(t(wire), 20)),
                                  np.asarray(j_decode(jnp.asarray(wire), 20)))


def test_reattached_labels_refresh_the_count(indices):
    # a new LabelSet restarts at version 0: the scan's member count must
    # follow the new labels, not a count cached for the old set
    _, tidx, q, labels = indices
    tidx.search_filtered(q[:4], "rare", K)
    flipped = [[lab for lab in ls if lab != "rare"] + (["rare"] if i < 40 else [])
               for i, ls in enumerate(labels)]
    tidx.attach_labels(flipped)
    try:
        _, ids, stats = tidx.search_filtered(q[:4], "rare", K)
        assert (stats.cmps == 40).all()
        assert ((ids >= 0) & (ids < 40) | (ids < 0)).all()
    finally:
        tidx.attach_labels(labels)
