"""The port's sharded index (`parallel/sharded.py`) against the JAX
package's (one shard per device of the 8-device CPU mesh that
`conftest.py` sets up).

- A JAX index over the 8-device mesh (overlap-2 routing, a delete, labels,
  a packed layout), carried across by `convert.sharded_index_from_arrays`
  to an 8-shard port index: full, filtered, packed and range search give
  bitwise-equal external ids (each shard's walk is the port's, which is
  already bitwise JAX's), distances within 1e-5 relative plus 1e-6 of
  the largest |q|^2 (the clustered neighbours lie ~0.1 away, where |q|^2 +
  |x|^2 - 2 q.x cancels below a few float32 ulps of the norms, and the
  two frameworks sum the products in different orders).  Records cross
  both ways: JAX's loads in the port and the port's rewrite is JAX's
  record byte for byte; the port's record loads in JAX.
- The 13 cases of `test_sharded.py`, on indexes the port builds itself
  with 4 shards.  Where a case measures recall, the JAX package builds the
  same data over a 4-device mesh, and the port must reach its recall less
  0.01; no deleted external id is returned; each overlap copy appears once.
- The multi-device form (``shards`` a sequence of devices, one per shard)
  against the int form on the same data: build, full / packed / filtered /
  range search, delete, grow and save -> load give bitwise-equal ids,
  distances and cmps and byte-equal records, every shard on "cpu" and on
  two devices ("cpu" and "cpu:0" are distinct to the fan-out, which steps
  the shards of both in lockstep from the calling thread).  The lockstep
  driver itself: shard order, rounds, answers, the first failure raised
  and every generator closed.  The carried JAX
  index crosses into an 8-device list and keeps JAX's ids.  On a host
  without CUDA cards every device here is the CPU, so placement on
  cards is held on a card by `tests/test_torch_mesh_cuda.py` (marker
  `cuda`) and across four by the benchmark's sharded cell (`annbench/`).
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from diskann_tpu import FlatIndex as JFlat
from diskann_tpu import GraphConfig as JConfig
from diskann_tpu import Metric as JMetric
from diskann_tpu.bench.recall import knn_recall
from diskann_tpu.parallel import ShardedGraphIndex as JSharded
from diskann_tpu_torch import FlatIndex, GraphConfig, Metric
from diskann_tpu_torch.convert import sharded_index_from_arrays
from diskann_tpu_torch.parallel import ShardedGraphIndex, sharded_flat_search
from diskann_tpu_torch.parallel.sharded import _fan_out
from diskann_tpu_torch.parallel.partition import (
    estimate_build_ram_bytes, kmeans_partition, shard_lists,
)
from torch_port_helpers import CPU, assert_same_results, jax_sharded_arrays, lifecycle

S = 4          # the port's own indexes
CFG = dict(max_degree=16, l_build=32)


def _mesh(n_dev):
    return Mesh(np.array(jax.devices()[:n_dev]), axis_names=("shard",))


def _index(d, cap, **cfg):
    return ShardedGraphIndex(S, d, GraphConfig(**(CFG | cfg)), cap_per_shard=cap,
                             device=CPU)


def _jindex(d, cap, **cfg):
    return JSharded(_mesh(S), d, JConfig(**(CFG | cfg)), cap_per_shard=cap)


def _clustered(rng, n, d, nc=24, sigma=0.1, scale=1.0):
    centers = rng.standard_normal((nc, d)).astype(np.float32) * scale
    x = centers[rng.integers(0, nc, size=n)] + sigma * rng.standard_normal(
        (n, d)).astype(np.float32)
    return x, centers


def _queries(rng, centers, nq, sigma=0.1):
    return centers[rng.integers(0, len(centers), size=nq)] + sigma * rng.standard_normal(
        (nq, centers.shape[1])).astype(np.float32)


def _same(got, want, what, q):
    np.testing.assert_array_equal(got[1], want[1], err_msg=f"ids differ: {what}")
    atol = 1e-6 * float((q.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=atol, err_msg=what)


# ------------------------------------------------- a JAX index carried across
@pytest.fixture(scope="module")
def carried():
    rng = np.random.default_rng(11)
    n, d = 1200, 16
    x, centers = _clustered(rng, n, d)
    q = _queries(rng, centers, 32)
    j = JSharded(_mesh(8), d, JConfig(**CFG), cap_per_shard=512)
    j.insert(x, np.stack([np.arange(n) % 8, (np.arange(n) + 1) % 8], axis=1))
    j.delete(rng.choice(n, size=60, replace=False))
    red = rng.random(n) < 0.35
    j.attach_labels([["red"] if r else ["blue"] for r in red])
    j.attach_packed(dp=16, train_sample=x[:512])
    return j, sharded_index_from_arrays(**jax_sharded_arrays(j)), x, q


@pytest.mark.parametrize("mode", ["full", "packed"])
def test_carried_search_matches_jax(carried, mode):
    j, p, _, q = carried
    assert p.n_shards == 8
    got = p.search(q, k=10, l_search=40, mode=mode)
    _same(got, j.search(q, k=10, l_search=40, mode=mode), mode, q)


@pytest.mark.parametrize("pred", ["red", "!red"])
def test_carried_filtered_search_matches_jax(carried, pred):
    j, p, _, q = carried
    _same(p.search_filtered(q, pred, k=10, l_search=48),
          j.search_filtered(q, pred, k=10, l_search=48), pred, q)


def test_sharded_cmps_sum_the_shards(carried):
    """The port counts every shard's distance computations; the reference's
    `shard_map` hands back the first shard's count."""
    from diskann_tpu_torch.graph.search import beam_search

    j, p, _, q = carried
    per = [beam_search(st.vectors, st.sq_norms, st.adjacency, p.starts[s], torch.as_tensor(q),
                       metric=p.config.metric, l_search=40, beam_width=p.config.beam_width,
                       max_hops=p.config.max_hops).cmps.numpy()
           for s, st in ((s, p.shard(s)) for s in range(p.n_shards))]
    np.testing.assert_array_equal(p.search(q, k=10, l_search=40)[2], np.sum(per, axis=0))
    np.testing.assert_array_equal(j.search(q, k=10, l_search=40)[2], per[0])


def test_carried_range_search_matches_jax(carried):
    j, p, x, q = carried
    dall = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    radius = float(np.quantile(dall, 0.01))
    got = p.search_range(q, radius, l_init=32)
    want = j.search_range(q, radius, l_init=32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_records_cross_both_ways(carried, tmp_path):
    j, p, _, q = carried
    j.save(str(tmp_path / "j"))
    pl = ShardedGraphIndex.load(str(tmp_path / "j"), device=CPU)
    want = j.search(q, k=10, l_search=40)
    _same(pl.search(q, k=10, l_search=40), want, "JAX record in the port", q)
    pl.save(str(tmp_path / "p"))
    jm = json.loads((tmp_path / "j" / "manifest.json").read_text())
    pm = json.loads((tmp_path / "p" / "manifest.json").read_text())
    assert pm == jm
    for info in jm["artifacts"].values():
        assert ((tmp_path / "p" / info["file"]).read_bytes()
                == (tmp_path / "j" / info["file"]).read_bytes()), info["file"]
    p.save(str(tmp_path / "p2"))
    jl = JSharded.load(_mesh(8), str(tmp_path / "p2"))
    _same(jl.search(q, k=10, l_search=40), p.search(q, k=10, l_search=40),
          "port record in JAX", q)


# ------------------------------------------- test_sharded.py's 13 cases
def test_sharded_flat_matches_single(rng):
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    q = rng.standard_normal((16, 16)).astype(np.float32)
    d, i = sharded_flat_search(S, x, q, k=10, device=CPU)
    gt_d, gt_i = FlatIndex(x, Metric.L2, device=CPU).search(q, k=10)
    np.testing.assert_array_equal(i.numpy(), gt_i)
    np.testing.assert_array_equal(d.numpy(), gt_d)
    assert knn_recall(i.numpy(), JFlat(x, JMetric.L2).search(q, k=10)[1], 10) >= 0.99


def test_sharded_flat_keeps_tie_order():
    x = np.repeat(np.arange(40, dtype=np.float32)[:, None], 4, 1)
    x = np.concatenate([x, x, x])                   # each row three times
    q = x[:3] + 0.25
    d, i = sharded_flat_search(S, x, q, k=12, device=CPU)
    np.testing.assert_array_equal(i.numpy(), FlatIndex(x, device=CPU).search(q, k=12)[1])


def _recall_pair(x, q, k, l, build):
    """(port recall, JAX recall) of ``build(index)`` on both packages."""
    _, gt = FlatIndex(x, Metric.L2, device=CPU).search(q, k=k)
    out = []
    for make in (_index, _jindex):
        idx = make(x.shape[1], 512)
        build(idx)
        out.append(knn_recall(np.asarray(idx.search(q, k=k, l_search=l)[1]), gt, k))
    return out


def test_sharded_graph_build_and_search(rng):
    n, d = 1000, 16
    x, centers = _clustered(rng, n, d, nc=30)
    q = _queries(rng, centers, 50)
    assign = np.arange(n) % S

    def build(idx):
        for off in range(0, n, 500):
            idx.insert(x[off:off + 500], assign[off:off + 500])

    got, want = _recall_pair(x, q, 10, 40, build)
    assert got >= 0.9 and got >= want - 0.01, (got, want)


def test_sharded_filtered_search(rng):
    n, d = 1000, 16
    x, centers = _clustered(rng, n, d)
    q = _queries(rng, centers, 32)
    idx = _index(d, 512)
    idx.insert(x, np.stack([np.arange(n) % S, (np.arange(n) + 1) % S], axis=1))
    red = rng.random(n) < 0.35
    idx.attach_labels([["red"] if r else ["blue"] for r in red])
    fd, fi, _ = idx.search_filtered(q, "red", k=10, l_search=48)
    found = fi[fi >= 0]
    assert found.size > 0 and red[found].all()
    for row in fi:
        live = row[row >= 0]
        assert len(live) == len(set(live.tolist())), live
    gt_d = ((q[:, None, :] - x[None, red, :]) ** 2).sum(-1)
    gt = np.nonzero(red)[0][np.argsort(gt_d, axis=1)[:, :10]]
    assert knn_recall(fi, gt, 10) >= 0.85
    _, bi, _ = idx.search_filtered(q, "!red", k=5, l_search=48)
    bl = bi[bi >= 0]
    assert bl.size > 0 and (~red[bl]).all()
    # inserts after attach_labels, growth included, carry no labels
    idx.insert(_queries(rng, centers, 800))
    assert idx.cap_per_shard > 512
    _, fi2, _ = idx.search_filtered(q, "red", k=10, l_search=48)
    got2 = fi2[fi2 >= 0]
    assert got2.size > 0 and (got2 < n).all() and red[got2].all()


def test_kmeans_partition_overlap(rng):
    centers = rng.standard_normal((8, 8)).astype(np.float32) * 5
    x = centers[rng.integers(0, 8, size=400)] + 0.1 * rng.standard_normal(
        (400, 8)).astype(np.float32)
    _, assign = kmeans_partition(x, S, overlap=2, device=CPU)
    assert assign.shape == (400, 2)
    assert (assign[:, 0] != assign[:, 1]).all()
    lists = shard_lists(assign, S)
    assert sum(len(l) for l in lists) == 800
    assert min(len(l) for l in lists) > 20
    assert estimate_build_ram_bytes(1_000_000, 128, 83) > 0


def test_sharded_build_with_kmeans_partition(rng):
    n, d = 1600, 16
    x, centers = _clustered(rng, n, d, nc=16, scale=3.0)
    _, assign = kmeans_partition(x, S, overlap=1, device=CPU)
    idx = _index(d, 512)
    idx.insert(x, assign[:, 0])
    q = _queries(rng, centers, 40)
    dists, _, _ = idx.search(q, k=10, l_search=40)
    gt_d, _ = FlatIndex(x, Metric.L2, device=CPU).search(q, k=10)
    close = np.abs(dists - gt_d) <= 1e-3 + 1e-3 * np.abs(gt_d)
    assert close.mean() >= 0.7


def test_sharded_packed_search(rng):
    n, d = 1600, 16
    x, centers = _clustered(rng, n, d, nc=30)
    q = _queries(rng, centers, 40)
    idx = _index(d, 512)
    idx.insert(x, np.arange(n) % S)
    idx.attach_packed(dp=16, train_sample=x[:512])
    _, gids, _ = idx.search(q, k=10, l_search=40, mode="packed")
    _, gt = FlatIndex(x, Metric.L2, device=CPU).search(q, k=10)
    assert knn_recall(gids, gt, 10) >= 0.9


def test_sharded_overlap2_dedup(rng):
    n, d = 800, 16
    x, centers = _clustered(rng, n, d, nc=16)
    _, assign = kmeans_partition(x, S, overlap=2, device=CPU)
    q = _queries(rng, centers, 40)
    idx = _index(d, 1024)
    ext = idx.insert(x, assign)
    np.testing.assert_array_equal(ext, np.arange(n))
    cols = idx._host_arrays()["ext"]
    assert (np.bincount(cols[cols >= 0], minlength=n) == 2).all()
    _, gids, _ = idx.search(q, k=10, l_search=40)
    for row in gids:
        live = row[row >= 0]
        assert len(np.unique(live)) == len(live)
    _, gt = FlatIndex(x, Metric.L2, device=CPU).search(q, k=10)
    j = _jindex(d, 1024)
    j.insert(x, assign)
    want = knn_recall(j.search(q, k=10, l_search=40)[1], gt, 10)
    got = knn_recall(gids, gt, 10)
    assert got >= 0.9 and got >= want - 0.01, (got, want)


def test_sharded_overflow_grow_and_error(rng):
    d = 8
    x = rng.standard_normal((400, d)).astype(np.float32)
    idx = _index(d, 32, max_degree=8, l_build=16)
    with pytest.raises(ValueError, match="overflow"):
        idx.insert(x, np.zeros(400, np.int64), on_overflow="error")
    idx2 = _index(d, 32, max_degree=8, l_build=16)
    idx2.insert(x[:256], np.zeros(256, np.int64))
    assert idx2.cap_per_shard >= 256
    assert int(idx2.ns[0]) == 256
    _, gids, _ = idx2.search(x[:8] + 0.001, k=1, l_search=16)
    assert (gids[:, 0] == np.arange(8)).all()


def test_sharded_delete(rng):
    n, d = 800, 16
    x, _ = _clustered(rng, n, d)
    dead = rng.choice(n, size=130, replace=False)
    alive = np.setdiff1d(np.arange(n), dead)
    q = x[alive[:40]] + 0.02
    _, gt_i = FlatIndex(x[alive], Metric.L2, device=CPU).search(q, k=10)
    recalls = []
    for make in (_index, _jindex):
        idx = make(d, 512)
        idx.insert(x)
        idx.delete(dead)
        _, gids, _ = idx.search(q, k=10, l_search=48)
        gids = np.asarray(gids)
        assert not np.isin(gids[gids >= 0], dead).any()
        recalls.append(knn_recall(gids, alive[gt_i], 10))
    assert recalls[0] >= 0.85 and recalls[0] >= recalls[1] - 0.01, recalls


def test_sharded_save_load(tmp_path, rng):
    n, d = 800, 16
    x, _ = _clustered(rng, n, d)
    idx = _index(d, 256)
    idx.insert(x)
    q = x[:24] + 0.01
    want = idx.search(q, k=10, l_search=40)
    idx.save(str(tmp_path / "sharded"))
    re = ShardedGraphIndex.load(str(tmp_path / "sharded"), device=CPU)
    _same(re.search(q, k=10, l_search=40), want, "round trip", q)
    ext = re.insert(rng.standard_normal((32, d)).astype(np.float32))
    assert ext[0] == n


def test_sharded_range_search(rng):
    n, d = 1200, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    idx = _index(d, 512)
    idx.insert(x, np.stack([np.arange(n) % S, (np.arange(n) + 3) % S], axis=1))
    q = x[rng.choice(n, size=5, replace=False)] + 0.01
    dall = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    radius = float(np.quantile(dall, 0.008))
    got = idx.search_range(q, radius, l_init=32)
    for b in range(len(q)):
        want = set(np.nonzero(dall[b] <= radius)[0].tolist())
        have = [int(i) for i in got[b]]
        assert len(have) == len(set(have))
        assert set(have) <= want, set(have) - want
        assert len(have) >= 0.85 * len(want), (len(have), len(want))


def test_sharded_freelist_recycles_slots(rng):
    d = 8
    idx = _index(d, 128, max_degree=8, l_build=16)
    x = rng.standard_normal((256, d)).astype(np.float32)
    ext = idx.insert(x)
    ns_before = idx.ns.copy()
    idx.delete(ext[:64])         # round robin: 16 slots in each shard
    assert idx._free_total == 64
    y = rng.standard_normal((64, d)).astype(np.float32)
    ext2 = idx.insert(y)
    np.testing.assert_array_equal(idx.ns, ns_before)   # recycled, no growth
    _, gids, _ = idx.search(y[:16], k=1, l_search=24)
    assert (gids[:, 0] >= 0).all()
    assert not np.isin(gids[:, 0], ext[:64]).any()
    assert np.isin(ext2, gids[:, 0]).sum() >= 12


def test_sharded_delete_of_start_node_and_packed_mirror(rng):
    n, d = 2000, 32
    x, centers = _clustered(rng, n, d, sigma=0.3, scale=2.0)
    q = _queries(rng, centers, 40, sigma=0.3)
    _, gt_i = FlatIndex(x, Metric.L2, device=CPU).search(q, k=10)
    idx = _index(d, 1024)
    eids = idx.insert(x)
    idx.attach_packed(dp=32)
    e2 = idx.insert(rng.standard_normal((64, d)).astype(np.float32) * 0.05)
    host = idx._host_arrays()
    starts = host["starts"].ravel()
    start_ext = np.array([host["ext"][s, starts[s]] for s in range(S)])
    assert (start_ext >= n).any(), "precondition: a start moved to a new row"
    idx.delete(e2)
    host = idx._host_arrays()
    assert all(host["valid"][s, host["starts"][s, 0]] for s in range(S))
    for mode in ("full", "packed"):
        _, gids, _ = idx.search(q, k=10, l_search=48, mode=mode)
        assert knn_recall(gids, eids[gt_i], 10) >= 0.9, mode


# ---------------------------------------- the multi-device form on the CPU
PLACEMENTS = {"one_worker": [CPU] * S, "two_workers": ["cpu", "cpu:0"] * (S // 2)}


@pytest.fixture(scope="module")
def int_form(tmp_path_factory):
    return lifecycle(S, tmp_path_factory.mktemp("int_form"), device=CPU)


@pytest.mark.parametrize("placement", list(PLACEMENTS))
def test_device_list_matches_the_int_form(int_form, placement, tmp_path):
    assert_same_results(lifecycle(PLACEMENTS[placement], tmp_path), int_form)


@pytest.mark.parametrize("placement", list(PLACEMENTS))
def test_every_shard_lives_on_its_device(placement, tmp_path):
    names = PLACEMENTS[placement]
    idx = ShardedGraphIndex(names, 8, GraphConfig(max_degree=8, l_build=16),
                            cap_per_shard=16)
    assert idx.devices == [torch.device(d) for d in names]
    assert idx.device == idx.devices[0] and idx.n_shards == len(names)
    x = np.random.default_rng(2).standard_normal((64, 8)).astype(np.float32)
    idx.insert(x)
    idx.attach_packed(dp=8)
    idx.attach_labels([["a"]] * 64)
    for s, name in enumerate(names):
        want = torch.device(name).type        # a CPU tensor reports "cpu"
        tensors = (*idx.shard(s), idx.ext[s], idx.starts[s], idx.label_bits[s],
                   idx.packed[s].rows, idx.packed[s].proj)
        assert all(t.device.type == want for t in tensors)
    if placement == "one_worker":
        assert all(t.device == CPU for s in range(S) for t in idx.shard(s))


def test_carried_index_on_a_device_list_matches_jax(carried):
    j, _, _, q = carried
    p = sharded_index_from_arrays(**(jax_sharded_arrays(j) | {"device": [CPU] * 8}))
    assert p.devices == [CPU] * 8
    for mode in ("full", "packed"):
        _same(p.search(q, k=10, l_search=40, mode=mode),
              j.search(q, k=10, l_search=40, mode=mode), mode, q)
    _same(p.search_filtered(q, "red", k=10, l_search=48),
          j.search_filtered(q, "red", k=10, l_search=48), "red", q)


def test_device_list_of_the_wrong_length_raises(carried, tmp_path):
    _, p, _, _ = carried
    p.save(str(tmp_path / "r"))
    with pytest.raises(ValueError, match="8 shards, 4 devices"):
        ShardedGraphIndex.load(str(tmp_path / "r"), device=[CPU] * 4)
    with pytest.raises(ValueError, match="8 shards, 3 devices"):
        sharded_index_from_arrays(**(jax_sharded_arrays(carried[0]) | {"device": [CPU] * 3}))
    with pytest.raises(ValueError, match="not both"):
        ShardedGraphIndex([CPU] * 2, 8, device=CPU)


@pytest.mark.parametrize("placement", list(PLACEMENTS))
def test_sharded_flat_on_a_device_list_keeps_flat_ids(placement, rng):
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    x[500:540] = x[:40]                             # ties across blocks
    q = np.concatenate([x[:8] + 0.01, rng.standard_normal((8, 16)).astype(np.float32)])
    d, i = sharded_flat_search(PLACEMENTS[placement], x, q, k=12)
    gt_d, gt_i = FlatIndex(x, Metric.L2, device=CPU).search(q, k=12)
    np.testing.assert_array_equal(i.numpy(), gt_i)
    np.testing.assert_array_equal(d.numpy(), gt_d)
    want = sharded_flat_search(S, x, q, k=12, device=CPU)
    assert torch.equal(i, want[1]) and torch.equal(d, want[0])


def test_lockstep_fan_out_keeps_shard_order_raises_and_closes():
    devices = [torch.device(d) for d in ("cpu", "cpu:0") * 3]
    order = []

    def stepping(s):
        def steps():
            for k in range(s + 1):                  # shard s takes s + 1 steps
                order.append((k, s))
                answer = yield torch.tensor(k < s)  # the flag: more steps to come
                assert answer is (k < s)
            return s * 10
        return steps()

    assert _fan_out(devices, stepping) == [0, 10, 20, 30, 40, 50]
    # round k advances every live shard, in shard order, before round k + 1
    assert order == sorted(order) and len(order) == 21
    # a shard's function may return its result directly
    assert _fan_out(devices, lambda s: stepping(s) if s % 2 else -s) == [
        0, 10, -2, 30, -4, 50]

    closed, steps_taken = [], []

    def fails_on_three(s):
        def steps():
            try:
                for k in range(2):
                    if s == 3 and k == 1:
                        raise RuntimeError("shard 3 failed")
                    steps_taken.append(s)
                    yield torch.tensor(True)
                return s
            finally:
                closed.append(s)
        return steps()

    with pytest.raises(RuntimeError, match="shard 3 failed"):
        _fan_out(devices, fails_on_three)
    # every generator was closed, and no shard after 3 took another step
    assert sorted(closed) == list(range(6))
    assert steps_taken == [0, 1, 2, 3, 4, 5, 0, 1, 2]
