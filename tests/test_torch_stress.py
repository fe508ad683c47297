"""Mutation-interleaving stress of the port (the `tests/test_stress.py`
schedule on `diskann_tpu_torch`).

Long seeded random interleavings of insert, delete, search and consolidate
on a packed index, with every structural invariant checked after every
mutation: degrees match rows, no self-loops, no duplicates, deleted rows
cleared, ids in range, the packed fat rows mirror adjacency exactly (with
no hand re-mirror after `consolidate`), and live accounting.  Deletes take
the method x repair pairs in turn, so every pair runs several times.
"""

import numpy as np
import pytest

from diskann_tpu_torch import FlatIndex, GraphConfig, GraphIndex
from diskann_tpu_torch.bench.recall import knn_recall
from torch_port_helpers import CPU, n

PAIRS = [(m, r) for m in ("scan", "one_hop", "two_hop_one_hop", "visited_topk")
         for r in ("prune", "fill")]


def check_invariants(idx, ctx):
    cap = idx.state.capacity
    adj = n(idx.state.adjacency)
    degs = n(idx.state.degrees)
    valid = n(idx.state.valid)
    np.testing.assert_array_equal(degs, (adj >= 0).sum(axis=1), err_msg=ctx)
    assert not (adj == np.arange(cap)[:, None]).any(), ctx
    srt = np.sort(np.where(adj < 0, 2**31 - 1, adj), axis=1)
    assert not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] < 2**31 - 1)).any(), ctx
    assert (adj[~valid] == -1).all(), ctx
    assert adj.max() < cap, ctx
    fat = n(idx.packed.rows).reshape(-1, idx.packed.nwr * 128)[:cap]
    np.testing.assert_array_equal(fat[:, : adj.shape[1]], adj, err_msg=ctx)
    assert valid.sum() == idx.n_live, ctx
    assert len(set(idx.free_slots)) == len(idx.free_slots), ctx
    assert not valid[idx.free_slots].any(), ctx


@pytest.mark.parametrize("seed", [0, 1])
def test_mutation_interleaving_stress(seed):
    """200 random mutation steps; invariants checked after every one."""
    rng = np.random.default_rng(seed)
    d = 16
    centers = rng.standard_normal((16, d)).astype(np.float32)

    def make(m):
        a = rng.integers(0, 16, size=m)
        return (centers[a] + 0.2 * rng.standard_normal((m, d))).astype(np.float32)

    x0 = make(600)
    idx = GraphIndex.build(x0, GraphConfig(max_degree=12, l_build=24),
                           insert_batch_size=256, build_mode="packed",
                           packed_dp=16, capacity=1400, device=CPU)
    live = {i: x0[i] for i in range(600)}
    check_invariants(idx, "post-build")
    n_deletes = 0
    for step in range(200):
        op = rng.choice(["insert", "delete", "search", "consolidate"],
                        p=[0.35, 0.35, 0.25, 0.05])
        ctx = f"seed={seed} step={step} op={op}"
        if op == "insert" and len(live) < 1200:
            v = make(int(rng.integers(1, 40)))
            ids = idx.insert(v)
            assert not set(ids.tolist()) & set(live), ctx   # never a live slot
            for j, s in enumerate(ids):
                live[int(s)] = v[j]
        elif op == "delete" and len(live) > 100:
            kill = rng.choice(np.array(sorted(live)), size=int(rng.integers(1, 40)),
                              replace=False)
            m, r = PAIRS[n_deletes % len(PAIRS)]
            n_deletes += 1
            ctx += f" method={m} repair={r}"
            idx.delete(kill, method=m, repair=r)
            for i in kill:
                del live[i]
        elif op == "search":
            q = make(8)
            _, ids, _ = idx.search(q, k=5, l_search=24)
            got = ids[ids >= 0]
            assert np.isin(got, np.array(sorted(live))).all(), ctx
            continue  # read-only
        else:
            idx.consolidate()
        check_invariants(idx, ctx)
    assert n_deletes >= 2 * len(PAIRS)

    # the surviving structure still answers queries well
    ids_live = np.array(sorted(live))
    lv = np.stack([live[i] for i in ids_live])
    q = lv[rng.choice(len(lv), size=40, replace=False)] + 0.02
    _, gt_i = FlatIndex(lv, device=CPU).search(q, k=10)
    _, got, _ = idx.search(q, k=10, l_search=48)
    assert knn_recall(got, ids_live[gt_i], 10) >= 0.8
