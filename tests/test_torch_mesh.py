"""The port's mesh (`parallel/mesh.py`): a `ShardedGraphIndex` whose shards
live in worker processes, one per device, spawned here on the CPU.

- A two-worker `Mesh` (one shard a worker) and a device list of two
  devices taken as cards (two shards a worker, stepped in lockstep there)
  run the whole lifecycle of `torch_port_helpers.lifecycle`: insert with
  growth, attach_packed, labels, full / packed / filtered / range search,
  delete, reinsert, save and load.  Every result, and the record's files,
  are bitwise the in-process int form's.
- A JAX index carried onto the mesh (`convert.sharded_index_from_arrays`)
  returns JAX's ids.
- A failure injected inside one worker (`torch_port_helpers`'
  injections, run there by `ShardedGraphIndex._run`) in an insert, in a
  delete's repair and in its packed refresh restores every worker
  bitwise and the host bookkeeping; the retry equals an in-process twin
  that never failed.
- A worker's out-of-memory error reaches the caller as
  `torch.OutOfMemoryError`, with the worker's traceback in its message.
- A worker killed between calls, or dying inside one, makes the call
  raise `RuntimeError` naming the device within a bounded time, and
  every later call raises too.  Dropping an index ends its workers.

On this host a device list names no CUDA card, so the tests that need
several shards in a worker take two CPU devices ("cpu" and "cpu:0") as
cards; `tests/test_torch_mesh_cuda.py` (marker `cuda`) runs the mesh on a
card.
"""

import gc
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from diskann_tpu import GraphConfig as JConfig
from diskann_tpu.parallel import ShardedGraphIndex as JSharded
from diskann_tpu_torch import GraphConfig
from diskann_tpu_torch.bench.harness import make_clustered
from diskann_tpu_torch.convert import sharded_index_from_arrays
from diskann_tpu_torch.parallel import Mesh, ShardedGraphIndex
from diskann_tpu_torch.parallel import sharded as tsharded
from torch_port_helpers import (
    CPU, assert_same_results, inject_refresh_failure, inject_step_failure,
    jax_sharded_arrays, lifecycle, raise_out_of_memory, undo_injections,
)

OOM = torch.cuda.OutOfMemoryError
# a device list of two CPU devices, taken as two cards: two workers, two
# shards each
CARDS = ["cpu", "cpu:0"] * 2
# how long a dead worker may take to be noticed
DEATH_S = 30.0


@pytest.fixture
def as_cards(monkeypatch):
    """Device lists of several CPU devices run on a mesh, as lists of
    several CUDA cards do."""
    monkeypatch.setattr(tsharded, "_spans_cards", lambda devs: len(set(devs)) > 1)


@pytest.fixture(scope="module")
def mesh():
    return Mesh([CPU] * 2)


def test_mesh_starts_one_worker_per_device(mesh):
    assert mesh.size == 2 and mesh.devices == [CPU, CPU]
    assert len(set(mesh.pids)) == 2 and os.getpid() not in mesh.pids
    assert mesh.run(os.getpid) == mesh.pids
    assert mesh.kernel_launches() == [{"fatrow_expand": 0, "block_patch": 0}] * 2


def test_mesh_lifecycle_matches_the_int_form(mesh, tmp_path):
    want = lifecycle(2, tmp_path / "int", device=CPU)
    got = lifecycle(mesh, tmp_path / "mesh")
    assert_same_results(got, want)


def test_card_list_lifecycle_matches_the_int_form(as_cards, tmp_path):
    want = lifecycle(4, tmp_path / "int", device=CPU)
    got = lifecycle(CARDS, tmp_path / "cards")
    assert_same_results(got, want)


@pytest.fixture(scope="module")
def jax_case():
    """A JAX index over a 4-device CPU mesh (overlap-2 routing, a delete,
    labels, a packed layout), its arrays, its queries and rows to add."""
    x, q = make_clustered(4, 700, 24, 16, n_clusters=24, sigma=0.1)
    j = JSharded(JMesh(np.array(jax.devices()[:4]), axis_names=("shard",)), 16,
                 JConfig(max_degree=16, l_build=32), cap_per_shard=512)
    j.insert(x[:600], np.stack([np.arange(600) % 4, (np.arange(600) + 1) % 4], axis=1))
    j.delete(np.random.default_rng(3).choice(600, size=40, replace=False))
    j.attach_labels([["red"] if i % 3 else ["blue"] for i in range(600)])
    j.attach_packed(dp=16, train_sample=x[:256])
    arrays = jax_sharded_arrays(j)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsharded, "_spans_cards", lambda devs: len(set(devs)) > 1)
        p = sharded_index_from_arrays(**(arrays | {"device": CARDS}))
    return j, arrays, p, q + 0.01, x[600:]


def test_carried_index_on_a_mesh_returns_jax_ids(jax_case):
    j, _, p, q, _ = jax_case
    assert p.mesh.devices == [CPU, torch.device("cpu", 0)] and p.n_shards == 4
    assert p._shards.of == {0: [0, 2], 1: [1, 3]}
    for mode in ("full", "packed"):
        np.testing.assert_array_equal(p.search(q, k=10, l_search=40, mode=mode)[1],
                                      j.search(q, k=10, l_search=40, mode=mode)[1], mode)
    np.testing.assert_array_equal(p.search_filtered(q, "red", k=10, l_search=48)[1],
                                  j.search_filtered(q, "red", k=10, l_search=48)[1])


def _snapshot(p) -> dict:
    """Every shard's tensors (copies) and the host bookkeeping."""
    out = {}
    arrays, packed, ext, starts = p.arrays, p.packed, p.ext, p.starts
    for s in range(p.n_shards):
        out |= {f"{s}/{f}": t.clone() for f, t in arrays[s]._asdict().items()}
        out |= {f"{s}/{f}": getattr(packed[s], f).clone()
                for f in ("self_codes", "self_aux", "rows")}
        out[f"{s}/ext"], out[f"{s}/start"] = ext[s].clone(), starts[s].clone()
    out["host"] = (p.ns.tolist(), p.next_ext, p.n_deleted, p._free_total, p.cap_per_shard)
    return out


def _assert_same(got: dict, want: dict, *, dump_row: bool = True) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if k.endswith("rows") and not dump_row:
            nwr = g.shape[0] // (got[k.removesuffix("rows") + "valid"].shape[0] + 1)
            g, w = g[:-nwr], w[:-nwr]
        assert torch.equal(g, w) if isinstance(w, torch.Tensor) else g == w, k


def test_a_failure_in_one_worker_restores_every_worker(jax_case):
    _, arrays, carried, q, new = jax_case
    p = carried._copy()                      # in the same workers
    twin = sharded_index_from_arrays(**(arrays | {"device": CPU}))
    assign = np.stack([np.arange(len(new)) % 4, (np.arange(len(new)) + 3) % 4], axis=1)
    doomed = np.arange(0, 600, 9)
    want = _snapshot(p)
    # the insert fails in shard 1's walk; the delete in shard 1's repair,
    # then in its second packed refresh (shard 1 lives in worker 1)
    for inject, args, call in (
            (inject_step_failure, ("diskann_tpu_torch.parallel.sharded",
                                   "insert_batch_steps", 1, 2), lambda: p.insert(new, assign)),
            (inject_step_failure, ("diskann_tpu_torch.graph.delete", "patch_rows_steps", 1, 1),
             lambda: p.delete(doomed)),
            (inject_refresh_failure, (1, 2, 64), lambda: p.delete(doomed))):
        p._run(inject, *args)
        try:
            with pytest.raises(OOM, match="injected"):
                call()
        finally:
            p._run(undo_injections)
        _assert_same(_snapshot(p), want)
    np.testing.assert_array_equal(p.search(q, k=10, l_search=40, mode="packed")[1],
                                  twin.search(q, k=10, l_search=40, mode="packed")[1])
    for i in (p, twin):
        np.testing.assert_array_equal(i.insert(new, assign), np.arange(600, 600 + len(new)))
        i.delete(doomed)
    _assert_same(_snapshot(p), _snapshot(twin), dump_row=False)


def test_out_of_memory_in_a_worker_keeps_its_type(mesh):
    with pytest.raises(torch.OutOfMemoryError, match="in the worker") as got:
        mesh.run(raise_out_of_memory, "in the worker", workers=[1])
    assert "raise_out_of_memory" in str(got.value)          # the worker's traceback
    assert mesh.run(os.getpid) == mesh.pids                 # the mesh goes on


def _raises_within(fn, what: str) -> float:
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=what):
        fn()
    return time.monotonic() - t0


def test_a_dead_worker_raises_and_never_hangs():
    x = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    idx = ShardedGraphIndex(Mesh([CPU]), 8, GraphConfig(max_degree=8, l_build=16),
                            cap_per_shard=64)
    idx.insert(x)
    os.kill(idx.mesh.pids[0], signal.SIGKILL)
    assert _raises_within(lambda: idx.search(x[:4], k=4), r"worker on cpu .* died") < DEATH_S
    assert _raises_within(lambda: idx.insert(x[:4]), "unusable") < DEATH_S
    # a worker dying inside a command
    m = Mesh([CPU])
    assert _raises_within(lambda: m.run(os._exit, 3), "exit code 3") < DEATH_S
    assert not any(p.is_alive() for p in m._procs)


def test_dropping_the_index_ends_its_workers():
    idx = ShardedGraphIndex(Mesh([CPU] * 2), 8, GraphConfig(max_degree=8, l_build=16),
                            cap_per_shard=16)
    procs = list(idx.mesh._procs)
    assert all(p.is_alive() for p in procs)
    del idx
    gc.collect()
    for p in procs:
        p.join(DEATH_S)
    assert not any(p.is_alive() for p in procs)
