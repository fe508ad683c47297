"""The port's `beam_search_scored` with the packed scorer, against the JAX
package's on a fixed JAX-built graph.

Both searches get the same query context (int8 query codes, scales,
squared norms): it rides in the ``queries`` argument, so the float32
projection that builds it, whose summation order differs between the
frameworks, is out of the comparison.  Then ids, ``cmps``, ``hops``, the
build pool and the filtered walks' matched lists are identical, and
distances agree within rtol 1e-6.  The filtered cases carry one label set
(30% "hot") to both packages: the inline walk of the packed filtered
search, multihop over the ring, and a pass resumed at a wider window
after `grow_resume_state` with ``reseed_ring``.  The stepping forms
(`beam_search_scored_steps`, `beam_search_steps`), driven by hand, give
bitwise the plain calls' results, and a False answer ends the walk there.
The packed scorer's whole hops (`ScorerDef.list_hop`: K1 and K3, here
their plain versions) give bitwise the generic loop's results, and only
the plain list walk at a beam one block holds takes them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diskann_tpu import GraphConfig as JConfig, GraphIndex as JIndex
from diskann_tpu.filters import LabelSet as JLabelSet
from diskann_tpu.filters import compile_accept as j_compile_accept
from diskann_tpu.filters import parse_predicate as j_parse
from diskann_tpu.graph.scorers import ScorerDef as JScorerDef
from diskann_tpu.graph.scorers import packed_scorer as j_packed_scorer
from diskann_tpu.graph.search import beam_search_scored as j_search
from diskann_tpu.graph.search import grow_resume_state as j_grow
from diskann_tpu_torch.convert import graph_index_from_arrays
from diskann_tpu_torch.filters import LabelSet, compile_accept, parse_predicate
from diskann_tpu_torch.graph.scorers import ScorerDef, packed_scorer
from diskann_tpu_torch.graph.search import (
    SearchResult, beam_search, beam_search_scored, beam_search_scored_steps,
    beam_search_steps, grow_resume_state, search_geometry,
)
from diskann_tpu_torch.ops.distance import Metric
from diskann_tpu_torch.ops.kernels import hop_merge as k3
from torch_port_helpers import jax_index_arrays, n, t

NQ = 96


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(41)
    centers = rng.standard_normal((32, 16)).astype(np.float32)
    x = centers[rng.integers(0, 32, 1024)] + 0.4 * rng.standard_normal(
        (1024, 16)).astype(np.float32)
    cfg = JConfig(max_degree=16, l_build=32, beam_width=4, router_size=0)
    jidx = JIndex.build(x, cfg, insert_batch_size=256, build_mode="packed",
                        packed_dp=16)
    tidx = graph_index_from_arrays(**jax_index_arrays(jidx))
    q = centers[rng.integers(0, 32, NQ)] + 0.4 * rng.standard_normal(
        (NQ, 16)).astype(np.float32)
    return jidx, tidx, q


def _ctx_prep_jax(dp):
    def prep(data, packed_q):
        return (packed_q[:, :dp].astype(jnp.int8), packed_q[:, dp],
                packed_q[:, dp + 1])
    return prep


def _ctx_prep_torch(dp):
    def prep(data, packed_q):
        return (packed_q[:, :dp].to(torch.int8), packed_q[:, dp].contiguous(),
                packed_q[:, dp + 1].contiguous())
    return prep


def _run_both(graphs, start_ids, filtered=False, resume=None, list_hop=False, **kw):
    """One search in each package on the same query context.  filtered:
    accept "hot" (30% of the nodes) with beta 0.5; resume: a (JAX, torch)
    pair of ResumeStates to continue from; list_hop: the port's scorer
    keeps its whole hops (the generic loop otherwise)."""
    jidx, tidx, q = graphs
    metric = jidx.config.metric
    jdef, jdata = j_packed_scorer(jidx.packed, metric)
    qi, qscale, qsq = jdef.prep(jdata, jnp.asarray(q))
    dp = jidx.packed.dp
    packed_q = np.concatenate(
        [np.asarray(qi, np.float32), np.asarray(qscale)[:, None],
         np.asarray(qsq)[:, None]], axis=1)
    jkw, tkw = dict(kw), dict(kw)
    if "query_valid" in kw:
        tkw["query_valid"] = t(kw["query_valid"])
    if filtered:
        cap = jidx.state.capacity
        hot = np.random.default_rng(9).random(cap) < 0.3
        labels = [["hot"] if h else ["cold"] for h in hot]
        jls = JLabelSet.from_lists(labels, capacity=cap)
        tls = LabelSet.from_lists(labels, capacity=cap)
        jkw.update(accept_fn=j_compile_accept(j_parse("hot"), jls.vocab, cap),
                   accept_data=jls.bits, filter_beta=0.5)
        tkw.update(accept_fn=compile_accept(parse_predicate("hot"), tls.vocab, cap),
                   accept_data=tls.bits, filter_beta=0.5)
    if resume is not None:
        jkw["resume_state"], tkw["resume_state"] = resume
    jdef2 = JScorerDef(jdef.name, _ctx_prep_jax(dp), jdef.score, jdef.expand)
    want = j_search(jdef2, jdata, jidx.state.adjacency, jnp.asarray(start_ids),
                    jnp.asarray(packed_q), expand_r=jidx.packed.r_pack, **jkw)
    tdef, tdata = packed_scorer(tidx.packed, Metric(metric.value))
    tdef2 = ScorerDef(tdef.name, _ctx_prep_torch(dp), tdef.score, tdef.expand,
                      tdef.list_hop if list_hop else None)
    got = beam_search_scored(tdef2, tdata, tidx.state.adjacency, t(start_ids),
                             t(packed_q), expand_r=tidx.packed.r_pack, **tkw)
    return want, got


def _assert_same(want, got, fields=("ids", "cmps", "hops", "match_i")):
    for f in fields:
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)))
    np.testing.assert_allclose(n(got.dists), np.asarray(want.dists), rtol=1e-6)
    np.testing.assert_allclose(n(got.match_d), np.asarray(want.match_d), rtol=1e-6)


def _starts(rng, jidx, per_query: bool):
    if not per_query:
        return np.array([int(jidx._start()[0]), 5, -1], np.int32)
    s = rng.integers(0, jidx.n, size=(NQ, 5)).astype(np.int32)
    s[:, 1] = s[:, 0]          # repeated start
    s[::4, 2] = -1             # missing start
    return s


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("l_search,max_hops", [(24, 512), (40, 3)])
def test_list_dedup_matches_jax(graphs, per_query, l_search, max_hops):
    rng = np.random.default_rng(l_search + max_hops + per_query)
    want, got = _run_both(graphs, _starts(rng, graphs[0], per_query),
                          l_search=l_search, beam_width=4, max_hops=max_hops,
                          dedup="list")
    np.testing.assert_array_equal(n(got.ids), np.asarray(want.ids))
    np.testing.assert_array_equal(n(got.cmps), np.asarray(want.cmps))
    np.testing.assert_array_equal(n(got.hops), np.asarray(want.hops))
    np.testing.assert_allclose(n(got.dists), np.asarray(want.dists), rtol=1e-6)


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("l_search,max_hops", [(24, 6), (90, 9), (40, 512)])
def test_list_hop_matches_jax(graphs, per_query, l_search, max_hops):
    # the packed list walk through whole hops (K1, then K3's plain version)
    rng = np.random.default_rng(l_search + max_hops + per_query)
    want, got = _run_both(graphs, _starts(rng, graphs[0], per_query), list_hop=True,
                          l_search=l_search, beam_width=4, max_hops=max_hops,
                          dedup="list")
    _assert_same(want, got)


def _no_list_hop(sdef):
    return dataclasses.replace(sdef, list_hop=None)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.InnerProduct])
@pytest.mark.parametrize("case", ["w4", "w1", "w8_short", "l_below_w", "trunc",
                                  "padded_rows"])
def test_list_hop_matches_the_generic_loop(graphs, metric, case):
    # every SearchResult field bitwise: beam widths 1 to 8, a list shorter
    # than the beam, merge_trunc, padded (converged-from-the-start) rows
    jidx, tidx, q = graphs
    rng = np.random.default_rng(len(case))
    kw = dict(l_search=24, beam_width=4, max_hops=512)
    kw.update({"w1": dict(beam_width=1), "w8_short": dict(beam_width=8, max_hops=3),
               "l_below_w": dict(l_search=3), "trunc": dict(merge_trunc=True),
               "padded_rows": dict(query_valid=t(rng.random(NQ) > 0.3))}.get(case, {}))
    tdef, tdata = packed_scorer(tidx.packed, metric)
    args = (tidx.state.adjacency, t(_starts(rng, jidx, True)), t(q))
    kw.update(dedup="list", expand_r=tidx.packed.r_pack)
    got = beam_search_scored(tdef, tdata, *args, **kw)
    _assert_bitwise(got, beam_search_scored(_no_list_hop(tdef), tdata, *args, **kw))


def test_only_the_plain_list_walk_takes_the_list_hop(graphs, monkeypatch):
    # one K3 call a hop in the plain packed list walk; none in the walks
    # that keep the generic body (merge and ring dedup, a reserve, a pool,
    # a returned state, a filter, a diversity quota, a beam whose W x
    # r_pack candidates one block cannot hold, a scorer without whole hops)
    _, tidx, q = graphs
    calls = []
    plain = k3.hop_merge
    monkeypatch.setattr(k3, "hop_merge", lambda *a, **kw: calls.append(a[6]) or plain(*a, **kw))
    tdef, tdata = packed_scorer(tidx.packed, Metric.L2)
    args = (tidx.state.adjacency, t(np.array([0, 5], np.int32)), t(q))
    base = dict(l_search=24, beam_width=4, max_hops=5, expand_r=tidx.packed.r_pack)
    beam_search_scored(tdef, tdata, *args, dedup="list", **base)
    assert calls == [0, 1, 2, 3, 4]
    cap = tidx.state.capacity
    labels = LabelSet.from_lists([["hot"] if h else ["cold"] for h in
                                  np.random.default_rng(9).random(cap) < 0.3], capacity=cap)
    bypass = [dict(dedup="merge"), dict(dedup="ring"), dict(dedup="list", reserve=8),
              dict(dedup="list", record_pool=True, pool_capacity=32),
              dict(dedup="list", return_state=True),
              dict(dedup="list", diverse_attrs=torch.zeros(cap, dtype=torch.int32),
                   diverse_l=2),
              dict(dedup="list", accept_data=labels.bits, filter_beta=0.5,
                   accept_fn=compile_accept(parse_predicate("hot"), labels.vocab, cap))]
    rp = tidx.packed.r_pack
    wide = next(w for w in range(1, 4096) if not k3.fits(w * rp, w, w))
    bypass.append(dict(dedup="list", l_search=wide, beam_width=wide, max_hops=2))
    for kw in bypass:
        calls.clear()
        beam_search_scored(tdef, tdata, *args, **{**base, **kw})
        assert not calls, kw
    beam_search_scored(_no_list_hop(tdef), tdata, *args, dedup="list", **base)
    assert not calls


@pytest.mark.parametrize("beam_width,max_hops,pool", [(4, 12, 128), (2, 40, 64)])
def test_merge_dedup_with_pool_matches_jax(graphs, beam_width, max_hops, pool):
    rng = np.random.default_rng(beam_width * max_hops)
    valid = rng.random(NQ) > 0.2
    want, got = _run_both(graphs, _starts(rng, graphs[0], True),
                          l_search=32, beam_width=beam_width, max_hops=max_hops,
                          dedup="merge", record_pool=True, pool_capacity=pool,
                          query_valid=valid)
    for f in ("ids", "cmps", "hops", "pool_i", "pool_n"):
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)))
    np.testing.assert_allclose(n(got.dists), np.asarray(want.dists), rtol=1e-6)
    np.testing.assert_allclose(n(got.pool_d), np.asarray(want.pool_d), rtol=1e-6)


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("l_search,max_hops", [(32, 512), (48, 4)])
def test_packed_inline_filter_matches_jax(graphs, per_query, l_search, max_hops):
    # the hop of the packed filtered search: list dedup, W=4, inline beta
    rng = np.random.default_rng(l_search + per_query)
    want, got = _run_both(graphs, _starts(rng, graphs[0], per_query), filtered=True,
                          l_search=l_search, beam_width=4, max_hops=max_hops,
                          dedup="list")
    _assert_same(want, got)
    assert (n(got.match_i) >= 0).sum() > 0


@pytest.mark.parametrize("dedup", ["ring", "list"])
def test_packed_multihop_matches_jax(graphs, dedup):
    rng = np.random.default_rng(4)
    want, got = _run_both(graphs, _starts(rng, graphs[0], True), filtered=True,
                          filter_mode="multihop", l_search=24, beam_width=2,
                          max_hops=40, dedup=dedup, history_capacity=512)
    _assert_same(want, got)


@pytest.mark.parametrize("filtered", [False, True])
def test_resumed_pass_matches_jax(graphs, filtered):
    # pass 1 at L=12, then both states grown to L=40 and resumed with the
    # frontier re-seeded from the scored-id ring
    jidx = graphs[0]
    starts = _starts(np.random.default_rng(8), jidx, True)
    kw = dict(filtered=filtered, beam_width=2, max_hops=512, dedup="ring",
              return_state=True)
    (want1, jst), (got1, tst) = _run_both(graphs, starts, l_search=12,
                                          history_capacity=256, **kw)
    _assert_same(want1, got1)
    l_tot, _, h = search_geometry(l_search=40, reserve=0, beam_width=2,
                                  r=jidx.state.adjacency.shape[1], s=starts.shape[1],
                                  expand_r=jidx.packed.r_pack, history_capacity=640)
    jst, tst = j_grow(jst, l_tot, h), grow_resume_state(tst, l_tot, h)
    for f in jst._fields:
        np.testing.assert_array_equal(n(getattr(tst, f)), np.asarray(getattr(jst, f)))
    (want, _), (got, _) = _run_both(graphs, starts, l_search=40, history_capacity=640,
                                    resume=(jst, tst), reseed_ring=True, **kw)
    _assert_same(want, got)
    assert (n(got.cmps) > n(got1.cmps)).any()


def test_unported_options_raise(graphs):
    # reserve, the diversity quota and merge_trunc are ported now (held
    # against JAX in test_torch_modes.py): they run, and unknown options
    # still raise
    _, tidx, q = graphs
    tdef, tdata = packed_scorer(tidx.packed, Metric.L2)
    args = (tdef, tdata, tidx.state.adjacency, torch.zeros(1, dtype=torch.int32), t(q))
    attrs = torch.zeros(tidx.state.capacity, dtype=torch.int32)
    for kw in (dict(reserve=4), dict(diverse_l=2), dict(merge_trunc=True),
               dict(diverse_attrs=attrs, diverse_l=1)):
        res = beam_search_scored(*args, l_search=8, dedup="list",
                                 expand_r=tidx.packed.r_pack, **kw)
        assert res.ids.shape == (len(q), 8 + kw.get("reserve", 0))
        if "diverse_attrs" in kw:       # one attribute, quota 1: one entry left
            assert (n(res.ids)[:, 1:] == -1).all() and (n(res.ids)[:, 0] >= 0).all()
    with pytest.raises(ValueError):
        beam_search_scored(*args, l_search=8, dedup="sorted")


def test_search_geometry_matches_jax():
    from diskann_tpu.graph.search import search_geometry as j_geom

    for dedup in ("ring", "list", "merge"):
        for kw in (dict(l_search=24, reserve=0, beam_width=4, r=83, s=5, expand_r=84),
                   dict(l_search=100, reserve=8, beam_width=1, r=20, s=1,
                        history_capacity=512)):
            assert search_geometry(dedup=dedup, **kw) == j_geom(dedup=dedup, **kw)


def _drive_by_hand(steps, answer=bool):
    """(result, flags yielded): ``steps`` driven to its end, each yielded
    flag answered with ``answer(flag)``."""
    yields, reply = 0, None
    while True:
        try:
            flag = steps.send(reply)
        except StopIteration as stop:
            return stop.value, yields
        yields += 1
        reply = answer(flag)


def _assert_bitwise(got, want):
    for f in SearchResult._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("dedup,kw", [
    ("list", {}),
    ("merge", dict(record_pool=True, pool_capacity=64)),
    ("ring", dict(history_capacity=256)),
])
def test_stepping_form_matches_the_plain_call(graphs, dedup, kw):
    _, tidx, q = graphs
    tdef, tdata = packed_scorer(tidx.packed, Metric.L2)
    args = (tdef, tdata, tidx.state.adjacency, t(np.array([0, 5], np.int32)), t(q))
    kw = dict(kw, l_search=24, beam_width=4, max_hops=512, dedup=dedup,
              expand_r=tidx.packed.r_pack)
    got, yields = _drive_by_hand(beam_search_scored_steps(*args, **kw))
    _assert_bitwise(got, beam_search_scored(*args, **kw))
    assert 2 < yields <= 512        # one flag a hop, the last one False
    # a False answer ends the walk where it stands: the start points alone
    got, yields = _drive_by_hand(beam_search_scored_steps(*args, **kw),
                                 answer=lambda flag: False)
    assert yields == 1
    _assert_bitwise(got, beam_search_scored(*args, **(kw | {"max_hops": 0})))


@pytest.mark.parametrize("max_hops", [512, 3])
def test_full_precision_stepping_form_matches_the_plain_call(graphs, max_hops):
    _, tidx, q = graphs
    st = tidx.state
    args = (st.vectors, st.sq_norms, st.adjacency, t(np.array([0, 5], np.int32)), t(q))
    kw = dict(metric=Metric.L2, l_search=32, beam_width=2, max_hops=max_hops,
              record_pool=True, pool_capacity=64)
    got, yields = _drive_by_hand(beam_search_steps(*args, **kw))
    _assert_bitwise(got, beam_search(*args, **kw))
    assert yields == max_hops if max_hops == 3 else 3 < yields < max_hops
