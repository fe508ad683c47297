"""Deletes and consolidations that fail part-way commit nothing, and their
retry gives the JAX package's clean result.

The port deletes in place.  `GraphIndex.delete` and `consolidate` save
what they overwrite in a `RowJournal` (the mark, the rows to repair, the
drop) and, when the call raises, restore it and rebuild the fat rows the
call refreshed from the restored adjacency.  One JAX packed index over 1,536 points
(d=32, R=12, dp=32) is built per module and carried across by
`convert.py`.  Each case injects a failure with `monkeypatch` at one point
of `graph/delete.inplace_delete` (the mark, discovery, the first and the
last repair batch, the drop, the first and the last packed refresh chunk;
after the real call has written what it writes) for each (method, repair)
pair, with repair batches small enough that every delete takes several,
then checks:

- after the failed delete, every `GraphArrays` and `PackedState` tensor,
  ``n``, ``n_deleted``, ``free_slots``, ``_start()`` and
  ``last_delete_stats`` are bitwise as before;
- after a retry, the index is bitwise the JAX package's after a clean
  delete of the same ids (adjacency, degrees, valid, every fat row but
  the dump row, the freelist, ``n_deleted``), and bitwise a port twin
  that never failed.

Also `consolidate` failing at each of its writers, and the regression of
the port before its deletes committed whole: a delete whose first repair
batch raised left its ids dead but never freed, so the retry deleted
nothing, leaked the 150 slots and left live rows naming them.
"""

import numpy as np
import pytest
import torch

from diskann_tpu import GraphConfig as JConfig
from diskann_tpu import GraphIndex as JIndex
from diskann_tpu_torch.bench.harness import make_clustered
from diskann_tpu_torch.convert import graph_index_from_arrays
from diskann_tpu_torch.graph import delete as tdel
from diskann_tpu_torch.graph import index as tindex
from diskann_tpu_torch.graph import packed as tpk
from test_torch_rollback import _assert_same, _copied, _fail_call, _snapshot
from torch_port_helpers import jax_clone, jax_index_arrays, n

D, N = 32, 1536
CFG = dict(max_degree=12, l_build=24, beam_width=4, router_size=0)
OOM = torch.cuda.OutOfMemoryError
DEAD = np.random.default_rng(5).choice(N, 150, replace=False)
PAIRS = [("scan", "prune"), ("scan", "fill"), ("one_hop", "prune"),
         ("visited_topk", "prune"), ("two_hop_one_hop", "fill")]
# repair batches and refresh chunks of a few hundred rows: ~1,000 rows are
# affected, so every delete takes several of each
SMALL_BATCH = {"fill": 256, "prune": 128}
DISCOVERY = {"scan": "rows_referencing_deleted", "one_hop": "_rows_that_reference_deleted",
             "two_hop_one_hop": "_rows_that_reference_deleted",
             "visited_topk": "_visited_topk"}
POINTS = ("mark", "discovery", "repair_first", "repair_last", "drop", "refresh_first",
          "refresh_last")


@pytest.fixture(scope="module")
def case():
    """The JAX index, its arrays, and a cache of clean JAX deletes."""
    x, _ = make_clustered(8, 1792, 8, D, n_clusters=32, sigma=0.35)
    j = JIndex.build(x[:N], JConfig(**CFG), insert_batch_size=256, build_mode="packed",
                     packed_dp=32, capacity=2048)
    return j, _copied(jax_index_arrays(j)), {}


def _jax_clean(case, method, repair, *, warm):
    """The JAX package's fields after a clean delete of DEAD; ``warm``: its
    start cache derived before the delete, as a port index whose `_start()`
    was read (visited_topk walks from it)."""
    j, _, cache = case
    key = (method, repair, warm)
    if key not in cache:
        c = jax_clone(j)
        if warm:
            c._start()
        c.delete(DEAD, method=method, repair=repair, k_value=12)
        cache[key] = {f: np.array(getattr(c.state, f)) for f in ("adjacency", "degrees", "valid")}
        cache[key] |= {"rows": np.array(c.packed.rows), "free_slots": list(c.free_slots),
                       "n_deleted": c.n_deleted}
    return cache[key]


def _port(case):
    return graph_index_from_arrays(**_copied(case[1]), insert_batch_size=256)


def _assert_jax(idx, want, twin):
    """``idx`` against JAX's clean delete ``want``: bitwise, apart from the
    rows where the port's clean delete ``twin`` already differs from JAX's,
    float32 near-ties of the prune (at most one row here: two candidates of
    row 948 lie 8e-6 apart at distance 7.13, and the two packages' distance
    sums order them differently); ``idx`` must equal ``twin`` there."""
    near = np.nonzero((n(twin.state.adjacency) != want["adjacency"]).any(1))[0]
    assert len(near) <= 1, near
    ok = ~np.isin(np.arange(idx.state.capacity), near)
    for f in ("adjacency", "degrees", "valid"):
        np.testing.assert_array_equal(n(getattr(idx.state, f))[ok], want[f][ok], err_msg=f)
    nwr = idx.packed.nwr
    ok_words = np.repeat(ok, nwr)       # the dump row aside
    np.testing.assert_array_equal(n(idx.packed.rows)[:len(ok_words)][ok_words],
                                  want["rows"][:len(ok_words)][ok_words])
    assert idx.free_slots == want["free_slots"] == DEAD.tolist()
    assert idx.n_deleted == want["n_deleted"] == len(DEAD)


def _state(idx) -> dict:
    return _snapshot(idx) | {"stats": idx.last_delete_stats}


def _where(point, method, repair, affected):
    """(module, attribute, call) of the failure point."""
    batches = -(-affected // SMALL_BATCH[repair])
    chunks = -(-(affected + len(DEAD)) // SMALL_BATCH[repair])
    repair_fn = "fill_rows" if repair == "fill" else "patch_rows"
    return {"mark": (tdel, "mark_deleted", 1),
            "discovery": (tdel, DISCOVERY[method], 1),
            "repair_first": (tdel, repair_fn, 1),
            "repair_last": (tdel, repair_fn, batches),
            "drop": (tdel, "drop_deleted_rows", 1),
            "refresh_first": (tpk, "refresh_rows", 1),
            "refresh_last": (tpk, "refresh_rows", chunks)}[point]


@pytest.mark.parametrize("point,pair,exc", [(p, pr, OOM) for p in POINTS for pr in PAIRS]
                         + [("drop", ("scan", "fill"), KeyboardInterrupt)])
def test_failed_delete_commits_nothing_and_retry_matches_jax(case, monkeypatch, point,
                                                              pair, exc):
    method, repair = pair
    kw = dict(method=method, repair=repair, k_value=12)
    monkeypatch.setattr(tdel, "_PATCH_BATCH", SMALL_BATCH)
    twin = _port(case)
    twin._start()
    twin.delete(DEAD, **kw)
    affected = twin.last_delete_stats["affected"]
    assert affected > 4 * SMALL_BATCH[repair]

    idx = _port(case)
    want = _state(idx)
    module, name, nth = _where(point, method, repair, affected)
    with monkeypatch.context() as mp:
        calls = _fail_call(mp, module, name, nth, exc)
        with pytest.raises(exc, match="injected"):
            idx.delete(DEAD, **kw)
    assert calls[0] >= nth
    _assert_same(_state(idx), want)

    idx.delete(DEAD, **kw)
    assert idx.last_delete_stats == {"deleted": len(DEAD), "affected": affected}
    _assert_jax(idx, _jax_clean(case, method, repair, warm=True), twin)
    _assert_same(_state(idx), _state(twin))


@pytest.mark.parametrize("point", ["repair", "drop", "refresh_last"])
def test_failed_consolidate_commits_nothing_and_retry_matches_jax(case, monkeypatch, point):
    # one_hop leaves rows that name deleted nodes; the sweep repairs them
    monkeypatch.setattr(tindex, "_CONSOLIDATE_ROWS", 16)
    j = jax_clone(case[0])
    j.delete(DEAD, method="one_hop", repair="fill")
    j.consolidate()
    idx, twin = _port(case), _port(case)
    for i in (idx, twin):
        i.delete(DEAD, method="one_hop", repair="fill")
    left = int(n(tdel.rows_referencing_deleted(idx.state)).sum())
    assert left > 2 * 16
    twin.consolidate()

    want = _state(idx)
    module, name, nth = {"repair": (tdel, "patch_rows", 2),
                         "drop": (tdel, "drop_deleted_rows", 1),
                         # the delete cleared the deleted rows: only the repaired
                         # rows are refreshed
                         "refresh_last": (tpk, "refresh_rows", -(-left // 16))}[point]
    with monkeypatch.context() as mp:
        _fail_call(mp, module, name, nth)
        with pytest.raises(OOM, match="injected"):
            idx.consolidate()
    _assert_same(_state(idx), want)

    idx.consolidate()
    # JAX's consolidate leaves its packed rows stale: the graph alone
    want = {f: np.asarray(getattr(j.state, f)) for f in ("adjacency", "degrees", "valid")}
    near = np.nonzero((n(twin.state.adjacency) != want["adjacency"]).any(1))[0]
    assert len(near) <= 1, near
    ok = ~np.isin(np.arange(idx.state.capacity), near)
    for f, w in want.items():
        np.testing.assert_array_equal(n(getattr(idx.state, f))[ok], w[ok], err_msg=f)
    assert not n(tdel.rows_referencing_deleted(idx.state)).any()
    _assert_same(_state(idx), _state(twin))


@pytest.mark.parametrize("method", ["scan", "visited_topk"])
def test_retry_after_a_failed_delete_frees_the_ids(case, monkeypatch, method):
    # the port before its deletes committed whole: the first repair batch
    # raised with the ids already dead, and the retry found none to delete
    # (0 freed, 0 counted, ~1,000 live rows naming them, len() 1,536)
    idx, twin = _port(case), _port(case)
    twin.delete(DEAD, method=method, k_value=12)
    assert idx._auto_start is None

    def oom(*a, **k):
        raise OOM("out of memory")

    with monkeypatch.context() as mp:
        mp.setattr(tdel, "patch_rows", oom)
        with pytest.raises(OOM):
            idx.delete(DEAD, method=method, k_value=12)
    # visited_topk derived the start from the marked state: it is dropped
    assert idx._auto_start is None and idx.last_delete_stats is None
    assert int(n(idx.state.valid).sum()) == N

    idx.delete(DEAD, method=method, k_value=12)
    assert sorted(idx.free_slots) == sorted(DEAD.tolist()) and idx.n_deleted == len(DEAD)
    assert len(idx) == N - len(DEAD)
    adj = n(idx.state.adjacency)[n(idx.state.valid)]
    if method == "scan":
        assert not np.isin(adj[adj >= 0], DEAD).any()
    _assert_jax(idx, _jax_clean(case, method, "prune", warm=False), twin)
    _assert_same(_state(idx), _state(twin))
