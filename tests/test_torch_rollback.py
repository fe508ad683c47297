"""Insert batches that fail part-way commit nothing, as the JAX package's.

The JAX package commits a batch by rebinding the state its pure batch
function returns, so a batch that raises leaves the index as it was
(`tests/test_failure.py`).  The port writes in place through a
`RowJournal` and restores it when the batch raises.  Each case injects a
failure with `monkeypatch` at one point of `graph/build.insert_batch_steps`
(the walk, the first prune, the 3a `refresh_rows`, the 3b `append_edges`,
the 3c prune, the 3c `refresh_rows`; after the real call has written what
it writes), then checks:

- after the failed insert, every `GraphArrays` and `PackedState` tensor,
  ``n``, ``n_deleted``, ``free_slots`` and ``_start()`` are bitwise as
  before;
- after a retry, the index is bitwise the JAX package's after the same
  insert (a JAX index carried across by `convert.py`, JAX's int8 codes of
  the new rows patched in, as `test_torch_index.py` does);
- a three-batch insert that fails in batch 2 keeps batch 1 and hands the
  freed slots of batches 2 and 3 back in their order (the JAX facade pops
  every slot before its loop and loses those);
- `ShardedGraphIndex`: a failure in shard 1's insert or delete step (or
  in its delete's packed refresh) leaves every shard and the host
  bookkeeping as before, and JAX's search answers on the carried index
  still hold; a retry equals a port twin that never failed.
"""

import copy

import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import jax
from diskann_tpu import GraphConfig as JConfig
from diskann_tpu import GraphIndex as JIndex
from diskann_tpu.parallel import ShardedGraphIndex as JSharded
from diskann_tpu_torch.bench.harness import make_clustered
from diskann_tpu_torch.convert import graph_index_from_arrays, sharded_index_from_arrays
from diskann_tpu_torch.graph import build as tbuild
from diskann_tpu_torch.graph import packed as tpk
from diskann_tpu_torch.parallel import sharded as tsharded
from torch_port_helpers import CPU, jax_index_arrays, jax_sharded_arrays, n, t

D = 32
CFG = dict(max_degree=12, l_build=24, beam_width=4, router_size=0)
OOM = torch.cuda.OutOfMemoryError


def _copied(arrays: dict) -> dict:
    """``arrays`` with every numpy array copied (JAX donates its buffers)."""
    return {k: _copied(v) if isinstance(v, dict) else
            np.array(v) if isinstance(v, np.ndarray) else copy.copy(v)
            for k, v in arrays.items()}


def _jax_case(mode):
    """A JAX index over 1,536 points: its arrays before the insert of 256
    more, those rows, its fields after that insert, and the snapshot of a
    port twin that made the same insert without a failure."""
    x, _ = make_clustered(8, 1792, 8, D, n_clusters=32, sigma=0.35)
    base, new = x[:1536], x[1536:]
    j = JIndex.build(base, JConfig(**CFG), insert_batch_size=256, build_mode=mode,
                     packed_dp=32, capacity=2048)
    before = _copied(jax_index_arrays(j))
    j.insert(new)
    after = {f: np.array(getattr(j.state, f)) for f in j.state._fields}
    after["start"] = np.array(j._start())
    if j.packed is not None:
        after |= {f: np.array(getattr(j.packed, f)) for f in ("self_codes", "self_aux", "rows")}
    with pytest.MonkeyPatch.context() as mp:
        twin = _carried(before, mp, after)
        twin.insert(new)
    return before, new, after, _snapshot(twin)


@pytest.fixture(scope="module")
def packed_case():
    return _jax_case("packed")


@pytest.fixture(scope="module")
def full_case():
    return _jax_case("full")


def _carried(before, monkeypatch, after=None, **kw):
    """The port index over ``before``; with ``after``, the new rows encode
    to JAX's int8 codes (the float32 projection may round one differently)."""
    idx = graph_index_from_arrays(**_copied(before), **({"insert_batch_size": 256} | kw))
    if after is not None and "self_codes" in after:
        codes, aux = after["self_codes"][1536:1792], after["self_aux"][1536:1792]
        monkeypatch.setattr(tpk, "encode", lambda *a: (t(codes), t(aux)))
    return idx


def _snapshot(idx) -> dict:
    """Every tensor of the state and the packed table, the counters, the
    freelist and the start point, copied."""
    out = {f: getattr(idx.state, f).clone() for f in idx.state._fields}
    if idx.packed is not None:
        out |= {f: getattr(idx.packed, f).clone() for f in ("self_codes", "self_aux", "rows")}
    out["host"] = (idx.n, idx.n_deleted, list(idx.free_slots), n(idx._start()).tolist())
    return out


def _assert_same(got: dict, want: dict, *, dump_row=True):
    """Bitwise equality of two snapshots; without ``dump_row`` each packed
    table's sacrificial last fat row (the target of masked writes, whose
    order is not fixed) is left out."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if k.endswith("rows") and not dump_row:
            # one fat row's word rows: the table has capacity + 1 of them
            nwr = g.shape[0] // (got[k.removesuffix("rows") + "valid"].shape[0] + 1)
            g, w = g[:-nwr], w[:-nwr]
        assert torch.equal(g, w) if isinstance(w, torch.Tensor) else g == w, k


def _fail_generator(monkeypatch, module, name, nth, exc=OOM):
    """Make the generator function ``module.name`` raise ``exc`` at the end
    of its ``nth`` call, after it ran; returns the call counter."""
    orig = getattr(module, name)
    calls = [0]

    def failing(*a, **k):
        calls[0] += 1
        out = yield from orig(*a, **k)
        if calls[0] == nth:
            raise exc("injected")
        return out

    monkeypatch.setattr(module, name, failing)
    return calls


def _fail_call(monkeypatch, module, name, nth, exc=OOM):
    """Make ``module.name`` raise ``exc`` after its ``nth`` call wrote."""
    orig = getattr(module, name)
    calls = [0]

    def failing(*a, **k):
        calls[0] += 1
        out = orig(*a, **k)
        if calls[0] == nth:
            raise exc("injected")
        return out

    monkeypatch.setattr(module, name, failing)
    return calls


# where insert_batch_steps fails: (module, attribute, call, generator?)
POINTS = {
    "walk": (tbuild, "beam_search_scored_steps", 1, True),
    "prune": (tbuild, "chunked_robust_prune_steps", 1, True),
    "refresh_3a": (tpk, "refresh_rows", 1, False),
    "append_edges": (tpk, "append_edges", 1, False),
    "prune_3c": (tbuild, "chunked_robust_prune_steps", 2, True),
    "refresh_3c": (tpk, "refresh_rows", 2, False),
}


def _inject(monkeypatch, point, exc=OOM):
    module, name, nth, gen = POINTS[point]
    return (_fail_generator if gen else _fail_call)(monkeypatch, module, name, nth, exc)


def _assert_jax(idx, after):
    for f in ("adjacency", "degrees", "vectors", "valid"):
        np.testing.assert_array_equal(n(getattr(idx.state, f)), after[f], err_msg=f)
    # float32 sums in another order than XLA's: the last bits may differ
    # (as in `test_torch_delete.py`); the twin below holds them bitwise
    np.testing.assert_allclose(n(idx.state.sq_norms), after["sq_norms"], rtol=1e-6)
    np.testing.assert_allclose(n(idx.state.vec_sum), after["vec_sum"], rtol=1e-5)
    np.testing.assert_array_equal(n(idx._start()), after["start"])
    if "rows" in after:
        live = idx.n * idx.packed.nwr
        np.testing.assert_array_equal(n(idx.packed.self_codes), after["self_codes"])
        np.testing.assert_array_equal(n(idx.packed.rows)[:live], after["rows"][:live])


@pytest.mark.parametrize("point,exc", [(p, OOM) for p in POINTS]
                         + [("append_edges", KeyboardInterrupt)])
def test_failed_batch_commits_nothing_and_retry_matches_jax(packed_case, monkeypatch,
                                                             point, exc):
    before, new, after, twin = packed_case
    idx = _carried(before, monkeypatch, after)
    want = _snapshot(idx)
    with monkeypatch.context() as mp:
        calls = _inject(mp, point, exc)
        with pytest.raises(exc, match="injected"):
            idx.insert(new)
    assert calls[0] == POINTS[point][2]
    _assert_same(_snapshot(idx), want)
    slots = idx.insert(new)
    np.testing.assert_array_equal(slots, np.arange(1536, 1792))
    assert (idx.n, idx.n_deleted, idx.free_slots) == (1792, 0, [])
    _assert_jax(idx, after)
    _assert_same(_snapshot(idx), twin, dump_row=False)


@pytest.mark.parametrize("point", ["prune", "prune_3c"])
def test_failed_full_precision_batch_commits_nothing(full_case, monkeypatch, point):
    before, new, after, twin = full_case
    idx = _carried(before, monkeypatch)
    assert idx.packed is None
    want = _snapshot(idx)
    with monkeypatch.context() as mp:
        _inject(mp, point)
        with pytest.raises(OOM):
            idx.insert(new)
    _assert_same(_snapshot(idx), want)
    idx.insert(new)
    _assert_jax(idx, after)
    _assert_same(_snapshot(idx), twin)


def test_failed_second_batch_keeps_the_first_and_frees_the_rest(packed_case, monkeypatch):
    # 150 freed slots, then 256 rows in batches of 96: batch 1 takes 96
    # freed slots, batch 2 the other 54 and 42 fresh ones, and fails; its
    # 54 go back on the freelist in their order, and batch 1 stays.
    before, new, _, _ = packed_case
    dead = np.random.default_rng(3).choice(1536, 150, replace=False)
    idx, twin = (_carried(before, monkeypatch, insert_batch_size=96) for _ in range(2))
    for i in (idx, twin):
        i.delete(dead)
    twin.insert(new[:96])
    with monkeypatch.context() as mp:
        _fail_call(mp, tpk, "append_edges", 2)
        with pytest.raises(OOM):
            idx.insert(new)
    assert idx.n_deleted == 150 - 96 and len(idx.free_slots) == 54
    # each side's batch 1 aimed several masked writes at the dump row, in
    # no fixed order: compare it on neither side
    _assert_same(_snapshot(idx), _snapshot(twin), dump_row=False)
    # the retry hands out the 54 freed slots first, then fresh ones
    slots = idx.insert(new[96:])
    np.testing.assert_array_equal(slots, twin.insert(new[96:]))
    np.testing.assert_array_equal(slots[:54], dead[::-1][96:])
    _assert_same(_snapshot(idx), _snapshot(twin), dump_row=False)


def test_failed_growth_leaves_the_index_as_it_was(packed_case, monkeypatch):
    before, new, _, _ = packed_case
    idx = _carried(before, monkeypatch)
    idx.delete(np.arange(10))
    want = _snapshot(idx)
    with monkeypatch.context() as mp:
        _fail_call(mp, tpk, "grow_packed", 1)
        with pytest.raises(OOM):
            idx.insert(np.concatenate([new, new, new]))     # past capacity 2048
    _assert_same(_snapshot(idx), want)
    assert idx.state.capacity == idx.packed.self_codes.shape[0] == 2048


# ------------------------------------------------------------ sharded
PLACEMENTS = {"one_worker": [CPU] * 8, "two_workers": ["cpu", "cpu:0"] * 4}


@pytest.fixture(scope="module")
def jax_sharded():
    """A JAX index over the 8-device CPU mesh (overlap-2 routing, a
    delete, a packed layout) and its query set."""
    rng = np.random.default_rng(11)
    x, _ = make_clustered(4, 1400, 24, 16, n_clusters=24, sigma=0.1)
    j = JSharded(Mesh(np.array(jax.devices()[:8]), axis_names=("shard",)), 16,
                 JConfig(max_degree=16, l_build=32), cap_per_shard=512)
    j.insert(x[:1200], np.stack([np.arange(1200) % 8, (np.arange(1200) + 1) % 8], axis=1))
    j.delete(rng.choice(1200, size=60, replace=False))
    j.attach_packed(dp=16, train_sample=x[:512])
    q = x[1200:1224] + 0.01
    return j, _copied(jax_sharded_arrays(j)), x[1224:], q


def _sharded_snapshot(p) -> dict:
    """`_snapshot` of every shard (its keys prefixed "s/"), with the host
    bookkeeping."""
    out = {}
    for s in range(p.n_shards):
        out |= {f"{s}/{f}": getattr(p.shard(s), f).clone() for f in p.shard(s)._fields}
        out |= {f"{s}/{f}": getattr(p.packed[s], f).clone()
                for f in ("self_codes", "self_aux", "rows")}
        out[f"{s}/ext"] = p.ext[s].clone()
        out[f"{s}/start"] = p.starts[s].clone()
    out["host"] = (p.ns.tolist(), p.next_ext, p.n_deleted, p._free_total, p.cap_per_shard)
    return out


def _fail_shard_step(monkeypatch, module, name, shard_arg, after_flags):
    """Make ``module.name`` (a stepping generator function whose first
    argument is a shard's `GraphArrays`) raise after ``after_flags`` flags
    when it runs on ``shard_arg``."""
    orig = getattr(module, name)

    def failing(st, *a, **k):
        gen = orig(st, *a, **k)
        if st is not shard_arg:
            return (yield from gen)
        answer = None
        for _ in range(after_flags):
            answer = yield gen.send(answer)
        gen.close()
        raise OOM("injected")

    monkeypatch.setattr(module, name, failing)


def _jax_parity(j, p, q):
    for mode in ("full", "packed"):
        jd, ji, _ = j.search(q, k=10, l_search=40, mode=mode)
        pd, pi, _ = p.search(q, k=10, l_search=40, mode=mode)
        np.testing.assert_array_equal(pi, ji, err_msg=mode)


@pytest.mark.parametrize("placement", list(PLACEMENTS))
def test_sharded_insert_and_delete_commit_on_every_shard_or_none(
        jax_sharded, monkeypatch, placement):
    j, arrays, new, q = jax_sharded
    p, twin = (sharded_index_from_arrays(**(_copied(arrays) | {"device": PLACEMENTS[placement]}))
               for _ in range(2))
    assign = np.stack([np.arange(len(new)) % 8, (np.arange(len(new)) + 3) % 8], axis=1)
    doomed = np.arange(0, 1200, 9)

    want = _sharded_snapshot(p)
    with monkeypatch.context() as mp:
        _fail_shard_step(mp, tsharded, "insert_batch_steps", p.shard(1), 2)
        with pytest.raises(OOM):
            p.insert(new, assign)
    _assert_same(_sharded_snapshot(p), want)
    _jax_parity(j, p, q)

    # the delete fails in shard 1's repair, then in its second packed refresh
    for inject in ("patch", "refresh"):
        with monkeypatch.context() as mp:
            if inject == "patch":
                _fail_shard_step(mp, tsharded.delete_mod, "patch_rows_steps", p.shard(1), 1)
            else:
                mp.setattr(tsharded, "_DELETE_CHUNK", 64)
                orig = tpk.refresh_rows
                calls = [0]

                def failing(packed, adjacency, rows, journal=None):
                    orig(packed, adjacency, rows, journal)
                    if packed is p.packed[1]:
                        calls[0] += 1
                        if calls[0] == 2:
                            raise OOM("injected")

                mp.setattr(tsharded.packed_mod, "refresh_rows", failing)
            with pytest.raises(OOM):
                p.delete(doomed)
        _assert_same(_sharded_snapshot(p), want)
    _jax_parity(j, p, q)

    for i in (p, twin):
        np.testing.assert_array_equal(i.insert(new, assign), np.arange(1200, 1200 + len(new)))
        i.delete(doomed)
    _assert_same(_sharded_snapshot(p), _sharded_snapshot(twin), dump_row=False)
