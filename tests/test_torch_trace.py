"""The port's tracing (`diskann_tpu_torch/trace.py`): the two cases of
`tests/test_trace.py`, the insert spans held equal to the JAX package's
(names and attributes) for one build, the tiered pipeline's spans; the
off path; the spans of one `GraphIndex` search, insert and delete and
their parents; the ``sync`` counter against the flags and fetches; each
span's profiler range inside its span on the profiler's clock; and the
spans of interleaved shard generators."""

import copy
import json

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from diskann_tpu_torch import GraphConfig, GraphIndex, trace
from diskann_tpu_torch.graph import steps
from torch_port_helpers import CPU


@pytest.fixture
def tracing():
    trace.clear_spans()
    trace.enable(True)
    yield trace
    trace.enable(False)
    trace.clear_spans()


def test_spans_nest_and_export(tracing, tmp_path):
    with trace.span("outer", job="x"):
        with trace.span("inner", step=1):
            pass
    sp = trace.spans()
    assert {s["name"] for s in sp} == {"outer", "inner"}
    inner = next(s for s in sp if s["name"] == "inner")
    outer = next(s for s in sp if s["name"] == "outer")
    assert inner["parent"] == outer["id"]
    assert outer["duration_ms"] >= inner["duration_ms"]
    out = str(tmp_path / "t.json")
    assert trace.export_spans(out) == 2
    assert len(json.load(open(out))["spans"]) == 2


def test_spans_are_off_by_default():
    trace.clear_spans()
    with trace.span("nothing"):
        with trace.wait("nor this"):
            pass
    assert trace.spans() == [] and trace.counters() == {}


def _insert_spans(spans):
    return [(s["name"], s["attributes"], s["parent"] is None) for s in spans
            if s["name"] == "insert.batch"]


def test_insert_spans_match_jax(tracing):
    from diskann_tpu import GraphConfig as JConfig, GraphIndex as JIndex
    from diskann_tpu import trace as jtrace

    x = np.random.default_rng(0xD15CA).standard_normal((600, 16)).astype(np.float32)
    GraphIndex.build(x, GraphConfig(max_degree=8, l_build=16), insert_batch_size=256,
                     device=CPU)
    port = _insert_spans(trace.spans())
    jtrace.clear_spans()
    jtrace.enable(True)
    try:
        JIndex.build(x, JConfig(max_degree=8, l_build=16), insert_batch_size=256)
    finally:
        jtrace.enable(False)
    want = _insert_spans(jtrace.spans())
    jtrace.clear_spans()
    assert len(port) >= 2
    assert port == want
    assert [a["offset"] for _, a, _ in port] == [0, 256, 512]
    assert [a["rows"] for _, a, _ in port] == [256, 256, 88]


def test_tiered_pipeline_spans(tracing):
    from diskann_tpu_torch.tiered import TieredIndex

    rng = np.random.default_rng(4)
    x = rng.standard_normal((400, 8)).astype(np.float32)
    q = rng.standard_normal((40, 8)).astype(np.float32)
    ti = TieredIndex.build_from_host(x, GraphConfig(max_degree=8, l_build=16), dp=8,
                                     insert_batch_size=256, device=CPU)
    ti.graph.attach_labels([["hot"] if i % 2 else [] for i in range(400)])
    trace.clear_spans()
    ti.search_batched(q, 5, l_search=16, batch_size=16)
    ti.search_filtered(q, "hot", 5, l_search=16, batch_size=32)
    got = [(s["name"], s["attributes"]) for s in trace.spans()]
    assert [a for n, a in got if n == "tiered.traverse"] == [
        {"offset": 0, "rows": 16}, {"offset": 16, "rows": 16}, {"offset": 32, "rows": 8}]
    assert [a for n, a in got if n == "tiered.traverse_filtered"] == [
        {"offset": 0, "rows": 32}, {"offset": 32, "rows": 8}]
    assert [a["offset"] for n, a in got if n == "tiered.stage_wait"] == [0, 16, 32, 0, 32]


# ------------------------------------------------------------ the port's spans
@pytest.fixture(scope="module")
def small():
    """A packed index of 1,200 points (router on) and 96 queries, built
    with tracing off."""
    rng = np.random.default_rng(0x5BA5)
    x = rng.standard_normal((1400, 16)).astype(np.float32)
    q = rng.standard_normal((96, 16)).astype(np.float32)
    cfg = GraphConfig(max_degree=8, l_build=16, router_size=256, router_starts=2)
    idx = GraphIndex.build(x[:1200], cfg, insert_batch_size=256, search_batch_size=64,
                           build_mode="packed", packed_dp=8, device=CPU)
    return idx, x, q


def _by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def _children(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


def test_off_path_is_one_shared_noop_and_records_nothing(small):
    idx, _, q = small
    assert trace.span("a") is trace.span("b", x=1) is trace.wait("sync")
    trace.clear_spans()
    idx.search(q, 5, mode="packed", l_search=16)
    assert trace.spans() == [] and trace.counters() == {}
    assert trace.fork(2) is None and trace.resume(None, 0) is trace.span("c")


def test_search_insert_delete_spans_and_parents(small, tracing):
    idx, x, q = small
    idx = copy.deepcopy(idx)
    for mode in ("packed", "full"):
        trace.clear_spans()
        idx.search(q, 5, mode=mode, l_search=16)
        sp = trace.spans()
        (root,) = _by_name(sp, "search")
        assert root["parent"] is None and root["trace"] == root["id"]
        assert root["attributes"] == {"mode": mode, "queries": 96}
        kids = _children(sp, root)
        # two query batches of 64 and 32, each router -> walk -> rerank
        assert [s["name"] for s in sorted(kids, key=lambda s: s["start_ns"])] == [
            "search.router", "search.walk", "search.rerank"] * 2
        assert len(sp) == 7 and {s["trace"] for s in sp} == {root["id"]}
        for s in kids:
            assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] <= root["end_ns"]

    trace.clear_spans()
    idx.insert(x[1200:1300])      # two calls of one minibatch each
    idx.insert(x[1300:1400])
    sp = trace.spans()
    batches = _by_name(sp, "insert.batch")
    assert [b["attributes"] for b in batches] == [{"offset": 0, "rows": 100}] * 2
    for b in batches:
        assert b["parent"] is None and b["trace"] == b["id"]
        assert sorted(s["name"] for s in _children(sp, b)) == [
            "insert.candidates", "insert.edges"]
    # each call samples the build-side router once (1,200 rows >= 4 x 256)
    routers = _by_name(sp, "insert.router")
    assert [r["attributes"] for r in routers] == [{"committed": 1200}, {"committed": 1300}]
    assert all(r["parent"] is None and r["trace"] == r["id"] for r in routers)
    assert len({s["trace"] for s in sp}) == 4 and len(sp) == 8

    trace.clear_spans()
    idx.delete(np.arange(0, 300, 3), method="scan", repair="fill")
    sp = trace.spans()
    (root,) = _by_name(sp, "delete")
    assert root["parent"] is None
    assert root["attributes"] == {"method": "scan", "repair": "fill", "rows": 100}
    assert sorted(s["name"] for s in _children(sp, root)) == ["delete.refresh",
                                                              "delete.repair"]
    assert len(sp) == 3 and {s["trace"] for s in sp} == {root["id"]}
    assert trace._stack() == []


def test_sync_count_is_the_flags_answered_plus_the_fetches(small, tracing, monkeypatch):
    idx, _, q = small
    flags = []
    run = steps.run

    def counting(gen):
        def counted():
            answer = None
            flag = gen.send(None)
            while True:
                flags.append(1)
                answer = yield flag
                try:
                    flag = gen.send(answer)
                except StopIteration as stop:
                    return stop.value
        return run(counted())

    monkeypatch.setattr(steps, "run", counting)
    trace.clear_spans()
    calls = 0
    for mode, b in (("packed", 96), ("full", 40), ("packed", 1)):
        idx.search(q[:b], 5, mode=mode, l_search=16, max_hops=5)
        calls += 1
    c = trace.counters()["sync"]
    assert flags and c["count"] == len(flags) + calls
    assert c["ns"] > 0


def test_profiler_ranges_sit_inside_their_spans(small, tracing):
    idx, x, q = small
    trace.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx.search(q[:70], 5, mode="packed", l_search=16)
        with trace.wait("sync"):
            pass
    t0 = prof.profiler.kineto_results.trace_start_ns()
    sp = trace.spans()
    names = {s["name"] for s in sp}
    assert {"search", "search.router", "search.walk", "search.rerank"} <= names
    events = [e for e in prof.events() if e.name in names | {"sync"}]
    for name in names:
        spans_ = sorted(_by_name(sp, name), key=lambda s: s["start_ns"])
        evs = sorted((e for e in events if e.name == name), key=lambda e: e.time_range.start)
        assert len(evs) == len(spans_) > 0
        for s, e in zip(spans_, evs):
            start_ns = t0 + e.time_range.start * 1e3
            end_ns = t0 + e.time_range.end * 1e3
            assert s["start_ns"] - 5e5 <= start_ns <= end_ns <= s["end_ns"] + 5e5
            # a function-scope range: Kineto gives it no device-side twin
            assert not getattr(e, "is_user_annotation", False)
    # every flag read and the fetch are ranges too
    assert sum(e.name == "sync" for e in events) == trace.counters()["sync"]["count"]


def test_profiler_ranges_without_tracing(small):
    idx, _, q = small
    trace.clear_spans()
    idx = copy.deepcopy(idx)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx.search(q[:8], 5, mode="packed", l_search=16)
        idx.delete([5, 6], method="scan", repair="fill")
        with trace.span("x") as rec:
            assert rec is None      # a span gives its record only while tracing
    got = {e.name for e in prof.events()}
    assert {"search", "search.router", "search.walk", "search.rerank", "sync", "delete",
            "delete.repair", "delete.refresh"} <= got
    assert trace.spans() == [] and trace.counters() == {}


def _two_shards():
    """An in-process two-shard index holding 100 rows, and 60 more rows."""
    from diskann_tpu_torch.parallel import ShardedGraphIndex

    rng = np.random.default_rng(7)
    x = rng.standard_normal((160, 8)).astype(np.float32)
    idx = ShardedGraphIndex(2, 8, GraphConfig(max_degree=8, l_build=16),
                            cap_per_shard=256, device=CPU)
    idx.insert(x[:100])
    return idx, x


def test_interleaved_shard_spans_nest_under_their_own_batch(tracing):
    idx, x = _two_shards()
    trace.clear_spans()
    with trace.span("outer"):
        idx.insert(x[100:])
    sp = trace.spans()
    (outer,) = _by_name(sp, "outer")
    batches = sorted(_by_name(sp, "insert.batch"), key=lambda s: s["attributes"]["shard"])
    assert [b["attributes"] for b in batches] == [{"shard": 0, "rows": 30},
                                                  {"shard": 1, "rows": 30}]
    for b in batches:
        assert b["parent"] == outer["id"] and b["trace"] == outer["id"]
        kids = _children(sp, b)
        assert sorted(s["name"] for s in kids) == ["insert.candidates", "insert.edges"]
        assert all(b["start_ns"] <= s["start_ns"] <= s["end_ns"] <= b["end_ns"]
                   for s in kids)
    # none lost, none left open; the two shards' walks overlapped in time
    assert len(sp) == 7 and trace._stack() == []
    cand = _by_name(sp, "insert.candidates")
    assert cand[0]["start_ns"] < cand[1]["end_ns"] and cand[1]["start_ns"] < cand[0]["end_ns"]
    assert trace.counters()["sync"]["count"] > 0


def test_interleaved_shard_ranges_under_the_profiler(tracing):
    """The shards' generators open and close their profiler ranges out of
    order on one thread: the profile still completes, builds its tree, and
    each range lies inside its own span."""
    idx, x = _two_shards()
    trace.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx.insert(x[100:])
    assert prof.key_averages() is not None
    t0 = prof.profiler.kineto_results.trace_start_ns()
    sp = trace.spans()
    names = ("insert.batch", "insert.candidates", "insert.edges")
    for name in names:
        spans_ = sorted(_by_name(sp, name), key=lambda s: s["start_ns"])
        evs = sorted((e for e in prof.events() if e.name == name),
                     key=lambda e: e.time_range.start)
        assert len(evs) == len(spans_) == 2
        for s, e in zip(spans_, evs):
            start_ns = t0 + e.time_range.start * 1e3
            end_ns = t0 + e.time_range.end * 1e3
            assert s["start_ns"] - 5e5 <= start_ns <= end_ns <= s["end_ns"] + 5e5
    # the two shards' candidate walks overlap: their ranges did not nest
    cand = sorted(_by_name(sp, "insert.candidates"), key=lambda s: s["start_ns"])
    assert cand[1]["start_ns"] < cand[0]["end_ns"] < cand[1]["end_ns"]
    assert sum(e.name == "sync" for e in prof.events()) == trace.counters()["sync"]["count"]
    assert trace._stack() == []
