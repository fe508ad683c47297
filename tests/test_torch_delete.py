"""The port's streaming deletes against the JAX package's.

One JAX index of each kind is built per module (n=1200 x 16 clustered,
R=12, L=24, W=4, batch 256; full precision, and packed at dp=16) and
carried across by `convert.py`; each case runs on a fresh copy of both.

- Bitwise: `mark_deleted` (``valid``; ``vec_sum`` within rtol 1e-5, a
  float sum in another order), `rows_referencing_deleted`,
  `drop_deleted_rows`, `fill_rows` and `patch_rows` on the same rows,
  `inplace_delete` for every method x repair (adjacency, degrees, valid,
  freelist, ``n_deleted``, the packed fat rows), an insert after a delete
  (same slots in the same order, same graph) and `consolidate`.
- The reference's double free: a repeated or already-deleted id goes on
  its freelist twice and is handed out twice; the port deletes each live
  id once.
- After `consolidate` the port's packed rows mirror adjacency with no
  hand re-mirror (the reference leaves them stale).
- Behaviour, on the port alone: deleted ids never come back, no dangling
  reference after "scan", recall after deletes, the graph invariants
  after every method and repair, and recall through churn.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest

from diskann_tpu import GraphConfig as JConfig
from diskann_tpu import GraphIndex as JIndex
from diskann_tpu.graph import delete as jdel
from diskann_tpu_torch import FlatIndex, GraphConfig, GraphIndex
from diskann_tpu_torch.bench.harness import make_clustered
from diskann_tpu_torch.bench.recall import knn_recall
from diskann_tpu_torch.convert import graph_index_from_arrays
from diskann_tpu_torch.graph import delete as tdel
from torch_port_helpers import CPU, jax_clone, jax_index_arrays, n, t

N, D = 1200, 16
CFG = dict(max_degree=12, l_build=24, beam_width=4, router_size=0)
METHODS = ("scan", "one_hop", "two_hop_one_hop", "visited_topk")
REPAIRS = ("prune", "fill")
DEAD = np.random.default_rng(5).choice(N, 150, replace=False)


@pytest.fixture(scope="module")
def data():
    return make_clustered(3, N + 200, 32, D, n_clusters=32, sigma=0.35)


def _jax_build(x, mode):
    return JIndex.build(x, JConfig(**CFG), insert_batch_size=256, build_mode=mode,
                        packed_dp=16, capacity=N + 256)


@pytest.fixture(scope="module")
def jax_indexes(data):
    x = data[0][:N]
    return {"full": _jax_build(x, "full"), "packed": _jax_build(x, "packed")}


@pytest.fixture
def pair(jax_indexes, request):
    """(JAX index, port index) over the same arrays; param: "full" or
    "packed"."""
    j = jax_clone(jax_indexes[request.param])
    return j, graph_index_from_arrays(**jax_index_arrays(j), insert_batch_size=256)


def _assert_same_graph(j, p):
    np.testing.assert_array_equal(n(p.state.adjacency), np.asarray(j.state.adjacency))
    np.testing.assert_array_equal(n(p.state.degrees), np.asarray(j.state.degrees))
    np.testing.assert_array_equal(n(p.state.valid), np.asarray(j.state.valid))
    if j.packed is not None:
        live = p.state.capacity * p.packed.nwr       # the dump row aside
        np.testing.assert_array_equal(n(p.packed.rows)[:live],
                                      np.asarray(j.packed.rows)[:live])


def _assert_packed_mirrors_adjacency(p):
    adj = n(p.state.adjacency)
    fat = n(p.packed.rows).reshape(-1, p.packed.nwr * 128)[: adj.shape[0]]
    np.testing.assert_array_equal(fat[:, : adj.shape[1]], adj)
    aux = fat[:, p.packed.idw * 128: p.packed.idw * 128 + adj.shape[1]].view(np.float32)
    np.testing.assert_array_equal(np.isfinite(aux), adj >= 0)


# ------------------------------------------------------------ the functions
@pytest.mark.parametrize("pair", ["full"], indirect=True)
def test_mark_rows_and_drop_match_jax(pair):
    j, p = pair
    jst = jdel.mark_deleted(j.state, jnp.asarray(DEAD, jnp.int32))
    marked = tdel.mark_deleted(p.state, DEAD)
    assert n(marked).tolist() == DEAD.tolist()
    np.testing.assert_array_equal(n(p.state.valid), np.asarray(jst.valid))
    np.testing.assert_allclose(n(p.state.vec_sum), np.asarray(jst.vec_sum),
                               rtol=1e-5, atol=1e-5)
    refs = np.asarray(jdel.rows_referencing_deleted(jst))
    assert refs.sum() > 100
    np.testing.assert_array_equal(n(tdel.rows_referencing_deleted(p.state)), refs)
    jst = jdel.drop_deleted_rows(jst)
    tdel.drop_deleted_rows(p.state)
    np.testing.assert_array_equal(n(p.state.adjacency), np.asarray(jst.adjacency))
    np.testing.assert_array_equal(n(p.state.degrees), np.asarray(jst.degrees))


@pytest.mark.parametrize("pair", ["full"], indirect=True)
@pytest.mark.parametrize("repair", REPAIRS)
def test_repair_rows_match_jax(pair, repair):
    # the same rows on both sides, one padded batch on the JAX side
    j, p = pair
    jst = jdel.mark_deleted(j.state, jnp.asarray(DEAD, jnp.int32))
    tdel.mark_deleted(p.state, DEAD)
    rows = np.nonzero(np.asarray(jdel.rows_referencing_deleted(jst)))[0]
    padded = np.pad(rows, (0, (-len(rows)) % 256 + 3), constant_values=-1).astype(np.int32)
    cfg = j.config
    if repair == "fill":
        jst = jdel.fill_rows(jst, jnp.asarray(padded), cfg, max_dead=4, repl_cap=8)
        tdel.fill_rows(p.state, t(padded), p.config, max_dead=4, repl_cap=8)
    else:
        jst = jdel.patch_rows(jst, jnp.asarray(padded), cfg, max_dead=4)
        tdel.patch_rows(p.state, t(padded), p.config, max_dead=4)
    np.testing.assert_array_equal(n(p.state.adjacency), np.asarray(jst.adjacency))
    np.testing.assert_array_equal(n(p.state.degrees), np.asarray(jst.degrees))


@pytest.mark.parametrize("pair", ["packed", "full"], indirect=True)
@pytest.mark.parametrize("repair", REPAIRS)
@pytest.mark.parametrize("method", METHODS)
def test_inplace_delete_matches_jax(pair, method, repair):
    j, p = pair
    kw = dict(method=method, repair=repair, k_value=12)
    j.delete(DEAD, **kw)
    p.delete(DEAD, **kw)
    _assert_same_graph(j, p)
    assert p.free_slots == j.free_slots == DEAD.tolist()
    assert p.n_deleted == j.n_deleted == len(DEAD)
    assert p.last_delete_stats["deleted"] == len(DEAD)
    if p.packed is not None:
        _assert_packed_mirrors_adjacency(p)


@pytest.mark.parametrize("pair", ["full"], indirect=True)
def test_insert_after_delete_matches_jax(pair, data):
    # the freed slots come back last-freed first, then fresh ones
    j, p = pair
    new = data[0][N:N + 200]
    j.delete(DEAD, method="scan", repair="fill")
    p.delete(DEAD, method="scan", repair="fill")
    js, ps = j.insert(new), p.insert(new)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(ps[:150], DEAD[::-1])
    np.testing.assert_array_equal(ps[150:], np.arange(N, N + 50))
    assert p.free_slots == j.free_slots == []
    assert (p.n, p.n_deleted, p.state.capacity) == (j.n, j.n_deleted, j.state.capacity)
    _assert_same_graph(j, p)
    np.testing.assert_array_equal(n(p.state.vectors), np.asarray(j.state.vectors))


@pytest.mark.parametrize("pair", ["packed"], indirect=True)
def test_consolidate_matches_jax_and_keeps_packed_mirror(pair):
    # one_hop leaves references outside its neighbourhood guess; the sweep
    # repairs them.  The reference leaves the packed rows it patched stale.
    j, p = pair
    for idx in (j, p):
        idx.delete(DEAD, method="one_hop", repair="fill")
    left = np.asarray(jdel.rows_referencing_deleted(j.state))
    assert left.sum() > 0
    np.testing.assert_array_equal(n(tdel.rows_referencing_deleted(p.state)), left)
    j.consolidate()
    p.consolidate()
    np.testing.assert_array_equal(n(p.state.adjacency), np.asarray(j.state.adjacency))
    np.testing.assert_array_equal(n(p.state.degrees), np.asarray(j.state.degrees))
    assert not n(tdel.rows_referencing_deleted(p.state)).any()
    _assert_packed_mirrors_adjacency(p)
    jfat = np.asarray(j.packed.rows).reshape(-1, j.packed.nwr * 128)[:N]
    assert (jfat[:, : j.state.adjacency.shape[1]] != np.asarray(j.state.adjacency)[:N]).any()


@pytest.mark.parametrize("pair", ["full"], indirect=True)
def test_repeated_and_dead_ids_free_once(pair):
    # reference fault: delete([5, 5, 7]) then delete([7]) frees 5 and 7
    # twice each, so the next insert hands slots 7 and 5 out twice
    j, p = pair
    for idx in (j, p):
        idx.delete(np.array([5, 5, 7]))
        idx.delete(np.array([7]))
    assert j.free_slots == [5, 5, 7, 7]
    assert j.n_live == N - 4 and int(np.asarray(j.state.valid).sum()) == N - 2
    assert p.free_slots == [5, 7] and p.n_deleted == 2
    assert p.n_live == int(n(p.state.valid).sum()) == N - 2
    new = np.random.default_rng(1).standard_normal((4, D)).astype(np.float32)
    assert j.insert(new).tolist() == [7, 7, 5, 5]
    slots = p.insert(new)
    assert slots.tolist() == [7, 5, N, N + 1]
    assert p.n_live == int(n(p.state.valid).sum()) == N + 2
    assert p.free_slots == []


# ------------------------------------------------------------ behaviour
def _clustered(rng, m, d=16, k=20, spread=0.15):
    centers = np.random.default_rng(99).standard_normal((k, d)).astype(np.float32)
    a = rng.integers(0, k, size=m)
    return (centers[a] + spread * rng.standard_normal((m, d))).astype(np.float32)


def _check_graph(idx):
    cap = idx.state.capacity
    adj = n(idx.state.adjacency)
    deg = n(idx.state.degrees)
    valid = n(idx.state.valid)
    np.testing.assert_array_equal((adj >= 0).sum(1), deg)
    np.testing.assert_array_equal(adj >= 0, np.arange(adj.shape[1])[None, :] < deg[:, None])
    assert not (adj == np.arange(cap)[:, None]).any(), "self-loop"
    srt = np.sort(np.where(adj < 0, 2**31 - 1, adj), axis=1)
    assert not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] < 2**31 - 1)).any(), "duplicate"
    assert (adj[~valid] == -1).all() and adj.max() < cap
    assert idx.n_live == int(valid.sum())


def _recall(idx, live_ids, vecs, q, l_search=48):
    _, gt = FlatIndex(vecs, device=CPU).search(q, 10)
    _, got, _ = idx.search(q, 10, l_search=l_search)
    return knn_recall(got, live_ids[gt], 10), got


@pytest.fixture(scope="module")
def port_built():
    rng = np.random.default_rng(0xD15CA)
    x = _clustered(rng, 1400)
    return x, GraphIndex.build(x, GraphConfig(max_degree=16, l_build=32),
                               insert_batch_size=512, device=CPU)


@pytest.mark.parametrize("method,repair", [(m, r) for m in METHODS for r in REPAIRS])
def test_delete_keeps_graph_searchable(port_built, method, repair):
    x, built = port_built
    idx = copy.copy(built)
    idx.state = type(built.state)(*(a.clone() for a in built.state))
    idx.free_slots = []
    rng = np.random.default_rng(7)
    dead = rng.choice(len(x), size=250, replace=False)
    alive = np.setdiff1d(np.arange(len(x)), dead)
    idx.delete(dead, method=method, repair=repair, k_value=12)
    assert idx.n_live == len(x) - 250
    _check_graph(idx)
    adj = n(idx.state.adjacency)
    if method == "scan":                  # the exact affected set
        assert not np.isin(adj[adj >= 0], dead).any()
    # queries right at deleted points never get them back
    _, ids, _ = idx.search(x[dead[:50]] + 0.01, 10, l_search=40)
    assert not np.isin(ids[ids >= 0], dead).any()
    r, got = _recall(idx, alive, x[alive], x[alive[:60]] + 0.02)
    assert not np.isin(got[got >= 0], dead).any()
    assert r >= 0.85, (method, repair, r)
    idx.consolidate()
    assert not n(tdel.rows_referencing_deleted(idx.state)).any()
    _check_graph(idx)


@pytest.mark.parametrize("case", ["quarter_scan_fill", "half_one_two_hop_prune"])
def test_churn_keeps_recall(case):
    # repeated delete + insert of the same count: recall must not decay
    rng = np.random.default_rng(0xD15CA)
    cycles, frac = (6, 4) if case == "quarter_scan_fill" else (10, 2)
    x = _clustered(rng, 1200, k=24)
    idx = GraphIndex.build(x, GraphConfig(max_degree=16, l_build=32),
                           insert_batch_size=256, device=CPU)
    live = {i: x[i] for i in range(len(x))}
    cap0 = idx.state.capacity
    recalls = []
    for c in range(cycles):
        ids_live = np.array(sorted(live))
        kill = rng.choice(ids_live, size=len(ids_live) // frac, replace=False)
        if case == "quarter_scan_fill":
            idx.delete(kill, method="scan", repair="fill")
        else:
            idx.delete(kill, method="two_hop_one_hop" if c % 2 else "one_hop")
        for i in kill:
            del live[i]
        newv = _clustered(rng, len(kill), k=24)
        slots = idx.insert(newv)
        assert sorted(slots.tolist()) == sorted(kill.tolist())   # recycled
        for j, s in enumerate(slots):
            live[int(s)] = newv[j]
        ids_live = np.array(sorted(live))
        lv = np.stack([live[i] for i in ids_live])
        r, _ = _recall(idx, ids_live, lv, lv[rng.choice(len(lv), 50, replace=False)] + 0.02)
        recalls.append(r)
    assert idx.state.capacity == cap0
    _check_graph(idx)
    assert min(recalls) >= 0.85, recalls
    half = cycles // 2
    assert np.mean(recalls[half:]) >= np.mean(recalls[:half]) - 0.05, recalls
