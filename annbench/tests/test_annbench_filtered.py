"""The label-filtered cell (`annbench.system.Filtered`), held back from
`BENCHMARK.json` in ``annbench/held/`` and laid over it here
(`small.with_held`; `test_annbench_sharded.py` holds every held entry
to the contract), at a small size (`small.FILTERED`) with all 200,386
tags: the seeded tags and predicates, the filtered exact answers against a
brute-force loop, the comparison's filtered ``bad_ids`` and recall on
planted answers, a run coming out correct (through today's entries and
through the per-query call shape, stubbed), each fault the cell can have
coming out not correct, and the control failing ``dist_gap``."""

import functools
import time
import types

import numpy as np
import pytest
import torch

from annbench import manifest, run, system
from annbench.control import Reused
from annbench.faults import planted
from annbench.reference import check, exact, synth
from annbench.reference.flat import Exact, round_tf32
from small import FILTERED, with_held

BENCH = with_held(manifest.Bench())
CELL = "yfcc.filtered-batch"
SEED = 2**31 + 4321
DATA = {"dim": 16, "sigma": 0.35, "clusters": 8, "slice_rows": 50, "grid": "uint8"}
TAGS = {"labels": {"vocab": 40, "per_row": {"mean": 3.0, "max": 6}, "zipf_s": 1.0,
                   "cluster_share": 0.5, "cluster_tags": 4},
        "predicates": {"and2_share": 0.5, "correlated_share": 0.5}}


def _run(*, seed=SEED, **kw):
    return run.run_cell(BENCH, CELL, seed=seed, seconds=0.5, trace=False, device="cpu",
                        t0=time.perf_counter(), overrides=FILTERED[CELL], **kw)


def _csr_lists(indptr, tags):
    return [set(tags[a:b].tolist()) for a, b in zip(indptr[:-1].tolist(), indptr[1:].tolist())]


def _members(bags, pred):
    return [r for r, bag in enumerate(bags) if all(t in bag for t in pred if t >= 0)]


@pytest.fixture(scope="module")
def built():
    """The filtered system of ``SEED``'s data, built by the first run that
    takes it and searched by the later ones."""
    reused = Reused()
    yield reused
    reused.shut()


def test_the_cell_is_held_back_with_the_published_widths():
    with pytest.raises(KeyError):
        manifest.Bench().cell(CELL)
    cell = BENCH.cell(CELL)
    assert cell["chips"] == 1 and cell["traffic"] == "closed-batch8192"
    cfg = BENCH.config(cell["config"])
    assert cfg["k"] == 10 and cfg["labels"]["vocab"] == 200386
    assert cfg["data"]["dim"] == 192 and cfg["data"]["grid"] == "uint8"
    assert cfg["data"]["n"] == 4_000_000 and cfg["reduced"] == ["data.n"]
    assert cfg["limits"] == {"bad_ids": {"max": 0}, "dist_gap": {"max": 0.0003},
                             "recall_at_10": {"min": 0.90}}
    assert cfg["serve"]["filtered"]["mode"] == "packed"
    assert "search" not in cfg["serve"]
    sift = BENCH.config("sift1m-vamana-r64")
    assert cfg["build"] == sift["build"]
    assert {m["name"] for m in BENCH.metrics(CELL, "end_to_end")} == {
        "search_qps", "recall_at_10", "setup_s"}
    assert {m["name"] for m in BENCH.metrics(CELL, "per_layer")} == {
        "hops_per_query.search", "fatrow_expand_roofline", "device_idle_share.search"}


def test_tags_and_predicates_repeat_per_seed_and_slices_stand_alone():
    data = synth.Clustered(SEED, DATA, "cpu")
    a, b = synth.Tagged(SEED, TAGS, data), synth.Tagged(SEED, TAGS, synth.Clustered(
        SEED, DATA, "cpu"))
    ip, tg = a.rows(0, 170)
    assert all(torch.equal(u, v) for u, v in zip((ip, tg), b.rows(0, 170)))
    assert ip[0] == 0 and ip[-1] == tg.shape[0] and (ip[1:] > ip[:-1]).all()
    # each row's tags ascending and distinct, within the vocabulary
    for r in range(170):
        t = tg[ip[r]:ip[r + 1]]
        assert (t[1:] > t[:-1]).all() and t.min() >= 0 and t.max() < 40
    ip2, tg2 = a.rows(120, 170)
    assert torch.equal(tg2, tg[ip[120]:ip[170]]) and torch.equal(ip2, ip[120:] - ip[120])
    assert torch.equal(a.slice(3)[1], a.rows(150, 200)[1])
    c = synth.Tagged(SEED + 1, TAGS, synth.Clustered(SEED + 1, DATA, "cpu"))
    assert not torch.equal(c.rows(0, 50)[1], a.rows(0, 50)[1])
    # the rows' clusters are those the rows were drawn around
    assert torch.equal(data.clusters(40, 120)[:10], data.clusters(0, 170)[40:50])
    p = a.predicates(300, 170)
    assert torch.equal(p, b.predicates(300, 170)) and p.dtype == torch.int32
    carried = set(tg.tolist())
    assert set(p[:, 0].tolist()) <= carried and set(p[p[:, 1] >= 0][:, 1].tolist()) <= carried
    assert (p[:, 0] != p[:, 1]).all() and 0.3 < (p[:, 1] >= 0).float().mean() < 0.7


def test_the_uint8_grid_is_whole_numbers_that_tf32_holds_exactly():
    x = synth.Clustered(SEED, DATA, "cpu").rows(0, 200)
    assert torch.equal(x, x.round()) and x.min() >= 0 and x.max() <= 255
    assert x.max() > 200 and x.min() < 50
    # why the control of a grid configuration is bfloat16 and not TF32: TF32
    # and bfloat16 inputs hold the grid exactly and a float32 product of
    # them is exact, but a product rounded to bfloat16 is not
    assert torch.equal(round_tf32(x), x) and torch.equal(x.bfloat16().float(), x)
    assert torch.equal(round_tf32(x) @ round_tf32(x).T, x.double().mm(x.double().T).float())
    assert not torch.equal((x.bfloat16() @ x.bfloat16().T).float(), x @ x.T)


def test_topk_matching_against_a_bruteforce_loop():
    data = synth.Clustered(SEED, DATA, "cpu")
    tags = synth.Tagged(SEED, TAGS, data)
    lo, hi = 30, 170
    x = data.rows(0, hi)
    q = data.queries(64)
    preds = tags.predicates(64, hi)
    ip, tg = tags.rows(0, hi)
    bags = _csr_lists(ip, tg)
    # a tag only deleted rows carry: no live row matches
    preds[0] = torch.tensor([next(t for t in set().union(*bags[:lo])
                                  if not any(t in bag for bag in bags[lo:])), -1])
    d, i, count = exact.topk_matching(q, x[lo:hi], 10, tags.rows(0, hi), preds, lo,
                                      q_chunk=8, n_chunk=32)
    few = 0
    for j in range(64):
        rows = [r for r in _members(bags, preds[j].tolist()) if lo <= r < hi]
        assert count[j] == len(rows)
        ref = ((q[j].double() - x[rows].double()) ** 2).sum(-1).numpy()
        want = [rows[o] - lo for o in np.argsort(ref, kind="stable")[:10]]
        got = i[j].tolist()
        assert got[:len(want)] == want and got[len(want):] == [-1] * (10 - len(want))
        assert np.allclose(d[j, :len(want)].numpy(), np.sort(ref)[:10], rtol=0, atol=1e-9)
        assert torch.isinf(d[j, len(want):]).all()
        few += len(want) < 10
    assert few >= 3 and count[0] == 0


def _filtered_answers():
    data = synth.Clustered(SEED, DATA, "cpu")
    tags = synth.Tagged(SEED, TAGS, data)
    lo, hi = 10, 60
    pool = data.queries(24)
    preds = tags.predicates(24, hi)
    x = data.rows(0, hi)
    _, truth, count = exact.topk_matching(pool, x[lo:hi], 10, tags.rows(0, hi), preds, lo)
    truth = torch.where(truth >= 0, truth + lo, -1)
    d = ((pool.double()[:, None] - x[truth.clamp(min=0)].double()) ** 2).sum(-1)
    d = torch.where(truth >= 0, d, float("inf"))
    answer = {"q": np.arange(24), "rows": truth.numpy().copy(), "dists": d.numpy(),
              "live": (lo, hi)}
    return data, tags, pool, preds, answer, count


def _measure(data, tags, pool, preds, answer):
    return check.measure([answer], [], data, pool, k=10, query_dtype=None, failed=0,
                         labels=tags, preds=preds)


def test_measure_judges_filtered_answers_by_the_matching_rows():
    data, tags, pool, preds, answer, count = _filtered_answers()
    due = int(count.clamp(max=10).sum())
    good = _measure(data, tags, pool, preds, answer)
    assert good["bad_ids"] == 0 and good["recall_at_10"] == 1.0 and good["dist_gap"] < 1e-9
    assert sum(b["queries"] for b in good["recall_by_band"].values()) == 24
    full = int(np.nonzero(count.numpy() >= 10)[0][0])
    short = int(np.nonzero(count.numpy() < 10)[0][0])
    bags = _csr_lists(*tags.rows(0, 60))
    other = next(r for r in range(10, 60)
                 if r not in _members(bags, preds[full].tolist()))
    rows = answer["rows"]
    bad = dict(answer, rows=rows.copy())
    bad["rows"][full, 9] = other              # a live row that does not match
    got = _measure(data, tags, pool, preds, bad)
    assert got["bad_ids"] == 1 and got["recall_at_10"] == pytest.approx((due - 1) / due)
    bad = dict(answer, rows=rows.copy())
    bad["rows"][full, 9] = -1                 # a -1 where k rows match
    assert _measure(data, tags, pool, preds, bad)["bad_ids"] == 1
    bad["rows"][full, 8] = bad["rows"][full, 7]   # a repeat
    assert _measure(data, tags, pool, preds, bad)["bad_ids"] == 2
    bad = dict(answer, rows=rows.copy())
    bad["rows"][short, 9] = 5                 # a deleted row where -1 was due
    assert _measure(data, tags, pool, preds, bad)["bad_ids"] == 1
    # the -1s a short answer holds are no fault, and nothing it could miss
    assert (rows[short] == -1).sum() == 10 - int(count[short])


def test_a_filtered_run_is_correct_with_its_end_to_end_metrics(built):
    res, rows = _run(make_system=built)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, rows
    assert set(res["metrics"]) == {"search_qps", "recall_at_10", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["checks"]["dist_gap"]["value"] < 1e-6
    # both routes of the port ran: the scan (no hops) and the walk
    hops = built.built.search(*_pool_slice(64))[2]
    assert (hops == 0).any() and (hops > 0).any()


def _pool_slice(n):
    cfg = manifest.merge(BENCH.config("yfcc-filtered-r64"), FILTERED[CELL]["config"])
    data = synth.Clustered(SEED, cfg["data"], "cpu")
    q = data.queries(n)
    return q.numpy(), synth.Tagged(SEED, cfg, data).predicates(n, cfg["data"]["n"]).numpy()


def test_one_call_per_predicate_answers_as_a_call_a_query(built):
    if built.built is None:
        _run(make_system=built)
    q, p = _pool_slice(48)
    d, i, hops = built.built.search(q, p)
    for j in range(48):
        dj, ij, hj = built.built.search(q[j:j + 1], p[j:j + 1])
        assert np.array_equal(ij[0], i[j]) and np.array_equal(dj[0], d[j])
        assert hj[0] == hops[j]


@pytest.mark.parametrize("fault,fails", [("filter-ignored", "bad_ids"),
                                         ("and-as-or", "bad_ids"),
                                         ("short-answer", "bad_ids")])
def test_each_fault_comes_out_not_correct(built, fault, fails):
    with planted(fault):
        res, rows = _run(make_system=built)
    assert not res["correct"], rows
    assert not next(r for r in rows if r["name"] == fails)["ok"], rows


def test_the_control_fails_dist_gap_and_the_reference_passes():
    res, rows = _run(make_system=functools.partial(Exact, precision="bf16"))
    assert not res["correct"]
    assert not next(r for r in rows if r["name"] == "dist_gap")["ok"]
    res, rows = _run(make_system=functools.partial(Exact, precision="float32"))
    assert res["correct"], rows


def test_a_port_that_takes_a_predicate_a_query_gets_one_call_a_step(monkeypatch):
    """The seam a port that sets ``filters.PER_QUERY_PREDICATES`` goes
    through: the tags handed over as CSR integer arrays, and each search
    step one ``search_filtered`` with the step's B predicates.  Both are
    stubbed over today's entries (names, one predicate a call)."""
    from diskann_tpu_torch import GraphIndex, filters

    attach, single = GraphIndex.attach_labels, GraphIndex.search_filtered
    calls = []

    def attach_csr(self, labels):
        indptr, tags = labels
        assert indptr.dtype.kind == "i" and tags.dtype.kind == "i"
        names = [str(t) for t in tags.tolist()]
        attach(self, [names[a:b] for a, b in zip(indptr[:-1].tolist(), indptr[1:].tolist())])

    def per_query(self, queries, predicates, k, **kw):
        assert isinstance(predicates, list) and len(predicates) == queries.shape[0]
        calls.append(len(predicates))
        outs = [single(self, queries[j:j + 1], p, k, **kw) for j, p in enumerate(predicates)]
        return (np.concatenate([o[0] for o in outs]), np.concatenate([o[1] for o in outs]),
                types.SimpleNamespace(hops=np.concatenate([o[2].hops for o in outs])))

    monkeypatch.setattr(filters, "PER_QUERY_PREDICATES", True, raising=False)
    monkeypatch.setattr(GraphIndex, "attach_labels", attach_csr)
    monkeypatch.setattr(GraphIndex, "search_filtered", per_query)
    res, rows = _run()
    assert res["correct"] and res["attempted"] > 0, rows
    step = FILTERED[CELL]["traffic"]["cycle"][0]["queries"]
    assert calls and set(calls) == {step}


def test_a_filtered_system_takes_no_inserts():
    cfg = manifest.merge(BENCH.config("yfcc-filtered-r64"), FILTERED[CELL]["config"])
    data = synth.Clustered(SEED, cfg["data"], "cpu")
    made = system.make(cfg, data.rows(0, 3000),
                       labels=synth.Tagged(SEED, cfg, data).rows(0, 3000))
    assert isinstance(made, system.Filtered)
    with pytest.raises(NotImplementedError):
        made.insert(data.rows(3000, 3010))
    made.close()
