"""Shared helpers of the PyTorch port's parity tests (`test_torch_*.py`).

Inputs are drawn from a numpy seed and handed to both packages as numpy
arrays; `jax_index_arrays` pulls the arrays of a JAX `GraphIndex` out for
`diskann_tpu_torch.convert.graph_index_from_arrays`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

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


@pytest.fixture
def cuda_device():
    """The first CUDA card; skips the test on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)
