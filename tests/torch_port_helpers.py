"""Shared helpers of the PyTorch port's parity tests (`test_torch_*.py`).

Inputs are drawn from a numpy seed and handed to both packages as numpy
arrays; `jax_index_arrays` pulls the arrays of a JAX `GraphIndex` out for
`diskann_tpu_torch.convert.graph_index_from_arrays`.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from diskann_tpu_torch.ops.kernels import native

# the suite runs under several worker processes: keep each one's torch
# thread pool small
torch.set_num_threads(2)

# the port's entry points run on the CUDA card unless asked otherwise; the
# parity tests ask for the CPU
CPU = torch.device("cpu")

PACKED_FIELDS = ("proj", "pscale", "pbias2", "self_codes", "self_aux", "rows")


def t(a) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor with the same dtype and values."""
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    """tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def jax_index_arrays(idx) -> dict:
    """Keyword arguments of `graph_index_from_arrays` for a JAX index."""
    cfg = dataclasses.asdict(idx.config)
    cfg["metric"] = idx.config.metric.value
    graph = {f: np.asarray(getattr(idx.state, f)) for f in idx.state._fields}
    packed = None
    if idx.packed is not None:
        packed = {f: np.asarray(getattr(idx.packed, f)) for f in PACKED_FIELDS}
        packed["r_pack"] = idx.packed.r_pack
    labels = None
    if getattr(idx, "labels", None) is not None:
        labels = {"vocab": dict(idx.labels.vocab), "bits": np.asarray(idx.labels.bits)}
    start = getattr(idx, "_cached_start", None)
    return dict(config=cfg, graph=graph, packed=packed, n=idx.n,
                n_deleted=idx.n_deleted, free_slots=list(idx.free_slots),
                labels=labels, device=CPU,
                cached_start=None if start is None else np.asarray(start),
                hbm_vectors_dropped=getattr(idx, "_hbm_vectors_dropped", False),
                **jax_attachments(idx))


def jax_clone(j):
    """A JAX index whose arrays are copies (the packed upkeep donates its
    buffers), with the start cache cleared so both sides derive it."""
    import copy

    import jax
    import jax.numpy as jnp

    c = copy.copy(j)
    c.free_slots = list(j.free_slots)
    c.state = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), j.state)
    if j.packed is not None:
        c.packed = dataclasses.replace(j.packed, **{
            f.name: jnp.array(getattr(j.packed, f.name), copy=True)
            for f in dataclasses.fields(j.packed) if f.name != "r_pack"})
    c._invalidate_start()
    return c


def jax_sharded_arrays(j) -> dict:
    """Keyword arguments of `sharded_index_from_arrays` for a JAX index."""
    cfg = dataclasses.asdict(j.config)
    cfg["metric"] = j.config.metric.value
    packed = None
    if j.packed is not None:
        packed = {f: np.asarray(getattr(j.packed, f)) for f in PACKED_FIELDS}
        packed["r_pack"] = j.packed.r_pack
    labels = None
    if j.label_bits is not None:
        labels = {"labels_per_ext": j._labels_per_ext, "vocab": j.label_vocab,
                  "bits": np.asarray(j.label_bits)}
    st = j.stacked
    return dict(config=cfg, stacked={f: np.asarray(getattr(st, f)) for f in st._fields},
                ext=np.asarray(j.ext), ns=np.asarray(j.ns), starts=np.asarray(j.starts),
                next_ext=j.next_ext, n_deleted=j.n_deleted, free_total=j._free_total,
                packed=packed, labels=labels, device=CPU)


def jax_attachments(idx) -> dict:
    """The quantized attachments of a JAX index, as the keyword arguments
    `pq`, `sq`, `minmax` and `spherical` of `graph_index_from_arrays`."""
    a = np.asarray
    out = {}
    if getattr(idx, "pq", None) is not None:
        out["pq"] = {"pivots": a(idx.pq.pivots), "dim": idx.pq.dim,
                     "codes": a(idx.pq_codes)}
    if getattr(idx, "sq", None) is not None:
        out["sq"] = {"scale": a(idx.sq.scale), "bias": a(idx.sq.bias),
                     "n_bits": idx.sq.n_bits, "codes": a(idx.sq_codes),
                     "bias2": a(idx.sq_bias2), "aux": a(idx.sq_aux)}
    if getattr(idx, "mm", None) is not None:
        out["minmax"] = {"codes": a(idx.mm_codes), "lo": a(idx.mm_lo),
                         "step": a(idx.mm_step), "aux": a(idx.mm_aux)}
    if getattr(idx, "sph", None) is not None:
        out["spherical"] = {"rotation": a(idx.sph.rotation), "n_bits": int(idx.sph.n_bits),
                            "words": a(idx.sph_words), "norms": a(idx.sph_norms),
                            "cscale": a(idx.sph_cscale)}
    return out


def rand_word_rows(rng, n_nodes: int, nwr: int) -> np.ndarray:
    """Random int32 word table [n_nodes * nwr, 128]."""
    return rng.integers(-(2**31), 2**31, size=(n_nodes * nwr, 128),
                        dtype=np.int64).astype(np.int32)


def launches(kernel: str) -> int:
    """The launches of CUDA kernel ``kernel`` so far in this process."""
    return native.launches[kernel]


@pytest.fixture
def cuda_device():
    """The first CUDA card; skips the test on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


# ------------------------------------------------- the sharded index's lifecycle
def lifecycle(shards, tmp, **kw):
    """Every operation of a `ShardedGraphIndex` (R=16, L=32), on ``shards``
    (an int and ``kw``, a device list or a `Mesh`): each result, and the
    record's files, by name."""
    from diskann_tpu_torch import GraphConfig
    from diskann_tpu_torch.parallel import ShardedGraphIndex

    rng = np.random.default_rng(31)
    centers = rng.standard_normal((24, 16)).astype(np.float32)
    x = centers[rng.integers(0, 24, size=600)] + 0.1 * rng.standard_normal(
        (600, 16)).astype(np.float32)
    q = centers[rng.integers(0, 24, size=24)] + 0.1 * rng.standard_normal(
        (24, 16)).astype(np.float32)
    idx = ShardedGraphIndex(shards, 16, GraphConfig(max_degree=16, l_build=32),
                            cap_per_shard=128, **kw)
    s_count = idx.n_shards
    out = {}
    idx.insert(x[:400], np.stack([np.arange(400) % s_count, (np.arange(400) + 1) % s_count], 1))
    out["grown_cap"] = np.array(idx.cap_per_shard)          # 200 rows a shard: grew
    idx.attach_packed(dp=16, train_sample=x[:256])
    idx.attach_labels([["red"] if i % 3 else ["blue"] for i in range(600)])
    for mode in ("full", "packed"):
        out[mode] = idx.search(q, k=10, l_search=32, mode=mode)
    out["filtered"] = idx.search_filtered(q, "blue", k=10, l_search=40)
    dall = ((q[:, None, :] - x[None, :400, :]) ** 2).sum(-1)
    out["range"] = idx.search_range(q[:6], float(np.quantile(dall, 0.01)), l_init=32)
    idx.delete(np.arange(0, 400, 7))
    idx.insert(x[400:])                      # recycles the freed slots
    for mode in ("full", "packed"):
        out[f"after_{mode}"] = idx.search(q, k=10, l_search=32, mode=mode)
    out["free_total"] = np.array(idx._free_total)
    idx.save(str(tmp))
    out["record"] = {f.name: f.read_bytes() for f in sorted(tmp.iterdir())}
    dev = shards if kw.get("device") is None else kw["device"]
    re = ShardedGraphIndex.load(str(tmp), device=dev)
    out["reloaded"] = re.search(q, k=10, l_search=32)
    return out


def assert_same_results(got: dict, want: dict) -> None:
    """Two `lifecycle` outputs bitwise equal, the record byte for byte."""
    assert got.keys() == want.keys()
    assert got["record"] == want["record"]
    for key, w in want.items():
        if key == "record":
            continue
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[key], w, err_msg=key)
            continue
        assert len(got[key]) == len(w), key       # (dists, ids, cmps) or range lists
        for g, ww in zip(got[key], w):
            np.testing.assert_array_equal(g, ww, err_msg=key)


# ------------------------------- failures injected where a shard's work runs
# A monkeypatch in the test's process does not reach a mesh worker; these
# run through `ShardedGraphIndex._run`, in each worker (or in process), and
# patch that process's modules.
_INJECTED: list = []


def _patch(module, name: str, value) -> None:
    _INJECTED.append((module, name, getattr(module, name)))
    setattr(module, name, value)


def inject_step_failure(shards, module: str, name: str, s: int, after_flags: int) -> None:
    """Make the stepping generator function ``module.name`` (its first
    argument a shard's `GraphArrays`) raise an injected out-of-memory
    error after ``after_flags`` flags on shard ``s``, where it is held."""
    mod = importlib.import_module(module)
    orig = getattr(mod, name)
    if s not in shards.ids:
        return
    target = shards.arrays[shards.ids.index(s)]

    def failing(st, *a, **k):
        gen = orig(st, *a, **k)
        if st is not target:
            return (yield from gen)
        answer = None
        for _ in range(after_flags):
            answer = yield gen.send(answer)
        gen.close()
        raise torch.cuda.OutOfMemoryError("injected")

    _patch(mod, name, failing)


def inject_refresh_failure(shards, s: int, nth: int, chunk: int) -> None:
    """Deletes refresh ``chunk`` fat rows a call, and the ``nth`` packed
    refresh of shard ``s`` raises an injected out-of-memory error after it
    ran, where the shard is held."""
    from diskann_tpu_torch.graph import packed as packed_mod
    from diskann_tpu_torch.parallel import sharded

    _patch(sharded, "_DELETE_CHUNK", chunk)
    if s not in shards.ids:
        return
    target, orig, calls = shards.packed[shards.ids.index(s)], packed_mod.refresh_rows, [0]

    def failing(packed, adjacency, rows, journal=None):
        orig(packed, adjacency, rows, journal)
        if packed is target:
            calls[0] += 1
            if calls[0] == nth:
                raise torch.cuda.OutOfMemoryError("injected")

    _patch(packed_mod, "refresh_rows", failing)


def undo_injections(shards) -> None:
    """Put back everything the injections above patched."""
    while _INJECTED:
        module, name, orig = _INJECTED.pop()
        setattr(module, name, orig)


def raise_out_of_memory(message: str) -> None:
    raise torch.cuda.OutOfMemoryError(message)
