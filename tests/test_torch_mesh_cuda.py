"""The port's mesh (`parallel/mesh.py`) on the card: two worker processes
on card 0 against the same index in this process.

- `torch_port_helpers.lifecycle` (insert with growth, attach_packed,
  labels, full / packed / filtered / range search, delete, reinsert, save
  and load) on a two-worker mesh is bitwise the in-process index's on the
  card, the record byte for byte;
- each worker counts the kernels it launches: K2 in the attach, K1 in the
  packed walk;
- `shard(s)` is a view of the worker's tensors on the card (CUDA IPC);
- a real out-of-memory error under a memory cap set inside the workers
  reaches the caller as `torch.OutOfMemoryError` and leaves every shard
  bitwise as before.

Every case needs the card (a CUDA kernel has no CPU mode) and is skipped
on a host without one.  No JAX here: on the card's host run
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_mesh_cuda.py``.
"""

import numpy as np
import pytest
import torch

from diskann_tpu_torch import GraphConfig
from diskann_tpu_torch.parallel import Mesh, ShardedGraphIndex
from torch_port_helpers import assert_same_results, cuda_device, lifecycle  # noqa: F401


def _memory_cap(headroom_mib) -> None:
    """Run in a worker: cap its card's memory at what it holds plus
    ``headroom_mib`` MiB (None: lift the cap)."""
    dev = torch.cuda.current_device()
    if headroom_mib is None:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        return
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(dev).total_memory
    in_use = torch.cuda.memory_allocated(dev)
    torch.cuda.set_per_process_memory_fraction((in_use + (headroom_mib << 20)) / total, dev)


@pytest.mark.cuda
def test_mesh_on_the_card_matches_this_process(cuda_device, tmp_path):
    want = lifecycle(2, tmp_path / "one", device=cuda_device)
    mesh = Mesh([cuda_device] * 2)
    got = lifecycle(mesh, tmp_path / "mesh")
    assert_same_results(got, want)


@pytest.mark.cuda
def test_workers_launch_the_kernels_and_share_views(cuda_device):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    q = x[:64] + 0.01
    idx = ShardedGraphIndex(Mesh([cuda_device] * 2), 32, GraphConfig(max_degree=16, l_build=32),
                            cap_per_shard=2048)
    idx.insert(x, np.stack([np.arange(3000) % 2, (np.arange(3000) + 1) % 2], 1))
    idx.mesh.kernel_launches()
    idx.attach_packed(dp=32)
    assert all(n["block_patch"] > 0 for n in idx.mesh.kernel_launches())
    idx.search(q, k=10, l_search=32, mode="packed")
    assert all(n["fatrow_expand"] > 0 for n in idx.mesh.kernel_launches())
    view = idx.shard(1)
    assert view.vectors.device == cuda_device and int(view.valid.sum()) == idx.ns[1]


@pytest.mark.cuda
def test_out_of_memory_under_a_cap_in_the_workers_restores_them(cuda_device):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((6000, 32)).astype(np.float32)
    mesh = Mesh([cuda_device] * 2)
    idx = ShardedGraphIndex(mesh, 32, GraphConfig(max_degree=16, l_build=32),
                            cap_per_shard=8192)
    idx.insert(x[:4000])
    idx.attach_packed(dp=32)
    before = [{f: t.clone() for f, t in st._asdict().items()} for st in idx.arrays]
    mesh.run(_memory_cap, 1)
    try:
        with pytest.raises(torch.OutOfMemoryError):
            idx.insert(x[4000:])
    finally:
        mesh.run(_memory_cap, None)
    for st, want in zip(idx.arrays, before):
        for f, t in st._asdict().items():
            assert torch.equal(t, want[f]), f
    assert idx.ns.tolist() == [2000, 2000] and idx.next_ext == 4000
    idx.insert(x[4000:])
    assert idx.ns.tolist() == [3000, 3000]
