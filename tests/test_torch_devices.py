"""The port's entry points run on the CUDA card unless asked otherwise.

With no ``device``, `GraphIndex`, `GraphIndex.build` (numpy input),
`graph_index_from_arrays`, `FlatIndex` (numpy input), `GraphIndex.load`,
`TieredIndex.build_from_host`, `TieredIndex.load` and `build_merged` put
their tensors on ``cuda``; on a host without a card they raise a clear error and never
fall back to the CPU.  An explicit device always wins, and a tensor keeps
the device it lies on.  This file imports no JAX, so it also runs on the
card's host (`--noconftest`), where the card branch is taken.
"""

import dataclasses

import numpy as np
import pytest
import torch

from diskann_tpu_torch import FlatIndex, GraphConfig, GraphIndex
from diskann_tpu_torch.convert import graph_index_from_arrays
from diskann_tpu_torch.tiered import TieredIndex, build_merged
from torch_port_helpers import CPU

X = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
# 16 dims: the packed walk's kernel takes dp in (16, 32, 64, 128)
X16 = np.random.default_rng(1).standard_normal((64, 16)).astype(np.float32)


def _arrays(device):
    idx = GraphIndex.build(X, GraphConfig(max_degree=8, l_build=16),
                           insert_batch_size=64, device=CPU)
    return dict(config=dataclasses.asdict(idx.config),
                graph={f: getattr(idx.state, f).numpy() for f in idx.state._fields},
                packed=None, n=idx.n, device=device)


CALLS = {
    "GraphIndex": lambda: GraphIndex(8).state.vectors,
    "GraphIndex.build": lambda: GraphIndex.build(X, insert_batch_size=64).state.vectors,
    "FlatIndex": lambda: FlatIndex(X).vectors,
    "graph_index_from_arrays": lambda: graph_index_from_arrays(**_arrays(None)).state.vectors,
}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A graph record and a tiered record, written on the CPU."""
    tmp = tmp_path_factory.mktemp("records")
    GraphIndex.build(X16, GraphConfig(max_degree=8, l_build=16), insert_batch_size=64,
                     device=CPU).save(str(tmp / "graph"))
    TieredIndex.build_from_host(X16, GraphConfig(max_degree=8, l_build=16), dp=16,
                                insert_batch_size=64, device=CPU).save(str(tmp / "tiered"))
    return tmp


STORAGE_CALLS = {
    "GraphIndex.load": lambda r: GraphIndex.load(str(r / "graph")).state.adjacency,
    "TieredIndex.load": lambda r: TieredIndex.load(str(r / "tiered")).graph.state.adjacency,
    "TieredIndex.build_from_host": lambda r: TieredIndex.build_from_host(
        X16, GraphConfig(max_degree=8, l_build=16), dp=16,
        insert_batch_size=64).graph.state.adjacency,
    "build_merged": lambda r: build_merged(
        X16, GraphConfig(max_degree=8, l_build=16), n_shards=3, dp=16,
        insert_batch_size=32).graph.state.adjacency,
}


@pytest.mark.parametrize("entry", sorted(STORAGE_CALLS))
def test_storage_entry_point_defaults_to_the_card(entry, records):
    if torch.cuda.is_available():
        assert STORAGE_CALLS[entry](records).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            STORAGE_CALLS[entry](records)


@pytest.mark.parametrize("entry", sorted(CALLS))
def test_entry_point_defaults_to_the_card(entry):
    if torch.cuda.is_available():
        assert CALLS[entry]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CALLS[entry]()


def test_explicit_device_and_tensor_device_win():
    assert GraphIndex(8, device="cpu").state.vectors.device.type == "cpu"
    assert FlatIndex(X, device=CPU).vectors.device.type == "cpu"
    assert FlatIndex(torch.from_numpy(X)).vectors.device.type == "cpu"
    idx = GraphIndex.build(torch.from_numpy(X), insert_batch_size=64)
    assert idx.device.type == "cpu" and idx.state.adjacency.device.type == "cpu"
    assert graph_index_from_arrays(**_arrays(CPU)).device.type == "cpu"
