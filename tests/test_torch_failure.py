"""The port's twins of `tests/test_failure.py`'s three index cases, each
run on both packages with the same seeded data: an insert batch aborted
in place leaves the state as it was (the JAX package's abort keeps its
previous state pytree; the port writes in place and restores its
`RowJournal`), a rejected insert leaves the index usable, and garbage
adjacency entries never crash a search, on the full route and on the
packed route, whose walk hands them to the K1 wrapper's clamp."""

import numpy as np
import pytest
import torch

from diskann_tpu import FlatIndex as JFlat
from diskann_tpu import GraphConfig as JConfig
from diskann_tpu import GraphIndex as JIndex
from diskann_tpu_torch import GraphConfig, GraphIndex
from diskann_tpu_torch.bench.recall import knn_recall
from diskann_tpu_torch.graph import packed as tpk
from diskann_tpu_torch.graph.build import insert_batch
from diskann_tpu_torch.graph.state import RowJournal
from torch_port_helpers import CPU, n, t

CFG = dict(max_degree=12, l_build=24)


def _mk(rng, n=800, d=16):
    centers = rng.standard_normal((12, d)).astype(np.float32)
    a = rng.integers(0, 12, size=n)
    return centers[a] + 0.2 * rng.standard_normal((n, d)).astype(np.float32)


def _both(x, **kw):
    """The same build in both packages (full precision, batch 256), which
    gives the same graph."""
    j = JIndex.build(x, JConfig(**CFG), insert_batch_size=256, **kw)
    p = GraphIndex.build(x, GraphConfig(**CFG), insert_batch_size=256, device=CPU, **kw)
    np.testing.assert_array_equal(n(p.state.adjacency), np.asarray(j.state.adjacency))
    return j, p


def test_mid_batch_abort_leaves_state_untouched(rng):
    """Abort: the batched insert runs on the LIVE state through a journal,
    then the journal is restored; the state must be byte-identical, and
    so the JAX package's, which never saw the batch."""
    x = _mk(rng)
    j, p = _both(x[:512], capacity=1024)     # room for the batch's slots
    before = {f: getattr(p.state, f).clone() for f in p.state._fields}

    m = 256
    journal = RowJournal()
    slots = torch.arange(p.n, p.n + m, dtype=torch.int32)
    insert_batch(p.state, slots, t(_mk(rng, n=m)), torch.ones(m, dtype=torch.bool),
                 p._start(), p.config, journal=journal)
    assert not torch.equal(p.state.adjacency, before["adjacency"])   # it wrote
    journal.restore()

    assert p.n == 512
    for f, v in before.items():
        assert torch.equal(getattr(p.state, f), v), f
    for f in ("adjacency", "degrees", "valid", "vectors"):
        np.testing.assert_array_equal(n(getattr(p.state, f)), np.asarray(getattr(j.state, f)))
    _, ids, _ = p.search(x[:8] + 0.01, k=5, l_search=24)
    assert (ids[:, 0] >= 0).all()


def test_insert_exception_does_not_corrupt(rng):
    """A host-side failure (bad input shape) raises before any write."""
    x = _mk(rng)
    j, p = _both(x)
    adj = p.state.adjacency.clone()
    for idx in (j, p):
        n0 = idx.n_live
        with pytest.raises(Exception):
            idx.insert(np.zeros((4, idx.dim + 3), np.float32))   # wrong dim
        assert idx.n_live == n0
    assert torch.equal(p.state.adjacency, adj) and p.free_slots == []
    _, jids, _ = j.search(x[:8] + 0.01, k=5, l_search=24)
    _, ids, _ = p.search(x[:8] + 0.01, k=5, l_search=24)
    assert (ids[:, 0] >= 0).all()
    np.testing.assert_array_equal(ids, jids)


@pytest.mark.parametrize("mode", ["full", "packed"])
def test_search_tolerates_corrupt_adjacency_entries(rng, mode):
    """Adjacency entries pointing at garbage ids (out of range, negative)
    are masked, never crash, never surface.  On the packed route the
    garbage reaches the fat rows (`refresh_rows`), so the walk hands it
    to the K1 wrapper as beam ids."""
    x = _mk(rng)
    j, p = _both(x)
    if mode == "packed":
        p.attach_packed(dp=16)
    rows = rng.choice(p.n, size=50, replace=False)
    cap = p.state.capacity
    p.state.adjacency[rows, 0] = cap + 1000     # out of range
    p.state.adjacency[rows, 1] = -7             # negative garbage
    if mode == "packed":
        tpk.refresh_rows(p.packed, p.state.adjacency, torch.as_tensor(rows))
        assert (tpk.logical_rows(p.packed)[rows, 0] == cap + 1000).all()
    _, gt_i = JFlat(x).search(x[:40] + 0.01, k=10)
    _, ids, _ = p.search(x[:40] + 0.01, k=10, l_search=32, mode=mode)
    assert (ids[ids >= 0] <= p.n).all()
    assert knn_recall(ids, np.asarray(gt_i), 10) >= 0.85
