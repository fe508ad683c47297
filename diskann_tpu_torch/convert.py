"""Carry an index across from the JAX package: numpy arrays in, a port
`GraphIndex` on a chosen device out.

The layouts are the same in both packages (int32 ids with -1 padding, the
``[(cap+1)*nwr, 128]`` int32 fat-row table with its dump row, the
vectors in their stored dtype, the quantized code tables), so the arrays
are copied as they are; uint32 words (labels, spherical codes) are carried
as int32 with the same bits, bfloat16 vectors as their uint16 bits where
numpy has no bfloat16 (no ml_dtypes).  Pulling the arrays out of a JAX
index is the caller's business: this package never imports JAX.

Quantized attachments are carried with their trained state (PQ pivots, SQ
ranges, the spherical rotation), so the port walks the same codes without
training again: the two packages' random streams differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diskann_tpu_torch.devices import default_device
from diskann_tpu_torch.filters.labels import LabelSet
from diskann_tpu_torch.graph.config import GraphConfig
from diskann_tpu_torch.graph.index import GraphIndex
from diskann_tpu_torch.graph.packed import PackedState, n_wrows
from diskann_tpu_torch.graph.state import (
    GraphArrays, dtype_name, vectors_from_host, vectors_to_host,
)
from diskann_tpu_torch.ops.distance import Metric
from diskann_tpu_torch.quant.minmax import MinMaxQuantizer
from diskann_tpu_torch.quant.pq import PQ
from diskann_tpu_torch.quant.scalar import ScalarQuantizer
from diskann_tpu_torch.quant.spherical import SphericalQuantizer

_GRAPH_DTYPES = {
    "sq_norms": torch.float32,
    "adjacency": torch.int32,
    "degrees": torch.int32,
    "valid": torch.bool,
    "vec_sum": torch.float32,
}
_PACKED_DTYPES = {
    "proj": torch.float32,
    "pscale": torch.float32,
    "pbias2": torch.float32,
    "self_codes": torch.int8,
    "self_aux": torch.float32,
    "rows": torch.int32,
}
# the per-row code tables of each quantized attachment, and their dtypes
_ATTACH_TABLES = {
    "pq": {"codes": ("pq_codes", torch.uint8)},
    "sq": {"codes": ("sq_codes", torch.int8), "aux": ("sq_aux", torch.float32)},
    "minmax": {"codes": ("mm_codes", torch.int8), "lo": ("mm_lo", torch.float32),
               "step": ("mm_step", torch.float32), "aux": ("mm_aux", torch.float32)},
    "spherical": {"words": ("sph_words", torch.int32),
                  "norms": ("sph_norms", torch.float32),
                  "cscale": ("sph_cscale", torch.float32)},
}


def _tensor(a, dtype, device) -> torch.Tensor:
    """A copy of numpy array ``a`` as ``dtype`` on ``device``; uint32 words
    keep their bits as int32."""
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a, device=device).to(dtype)


def graph_index_from_arrays(
    *,
    config: dict,
    graph: dict,
    packed: dict | None,
    n: int,
    n_deleted: int = 0,
    free_slots=(),
    labels: dict | None = None,
    pq: dict | None = None,
    sq: dict | None = None,
    minmax: dict | None = None,
    spherical: dict | None = None,
    cached_start=None,
    hbm_vectors_dropped: bool = False,
    dtype=None,
    device=None,
    **index_kwargs,
) -> GraphIndex:
    """Build a port `GraphIndex` from the reference index's arrays.

    config: the `GraphConfig` fields (``metric`` as a `Metric` or its
    value); graph: the `GraphArrays` fields as numpy arrays; packed: the
    `PackedState` fields as numpy arrays plus ``r_pack``, or None;
    n, n_deleted: the index's counters; free_slots: its freelist, in
    order (the last entry is reused first); labels: ``{"vocab": dict, "bits":
    [cap, n_words] uint32 array}`` of the reference's `LabelSet`, or None
    (the words are carried as int32 with the same bits).  The quantized
    attachments, each None or a dict of numpy arrays: pq ``{"pivots",
    "dim", "codes"}``; sq ``{"scale", "bias", "n_bits", "codes"}`` (the
    centred int8 codes), ``"bias2"``, ``"aux"``; minmax ``{"codes",
    "lo", "step", "aux"}``; spherical ``{"rotation", "n_bits", "words",
    "norms", "cscale"}``; every code table has capacity rows.
    cached_start: the pinned start point ([S] int array) or None;
    hbm_vectors_dropped: the graph's vectors were dropped from the device
    (``graph["vectors"]`` is then the [1, d] placeholder), as in a tiered
    index.  dtype: the vectors' dtype, by default ``graph["vectors"]``'s own
    (give "bfloat16" for uint16 bits).  index_kwargs go to `GraphIndex`
    (batch sizes, backedge cap).  The index goes on ``device``, by default
    the CUDA card."""
    device = default_device(device)
    cfg = dict(config)
    cfg["metric"] = Metric(cfg["metric"])
    cfg = GraphConfig(**cfg)

    def put(arrays, dtypes):
        # copies: the index updates its tensors in place
        return {k: torch.as_tensor(np.array(arrays[k]), device=device).to(dt)
                for k, dt in dtypes.items()}

    g = GraphArrays(vectors=vectors_from_host(graph["vectors"], dtype).to(device),
                    **put(graph, _GRAPH_DTYPES))
    cap, r_slack = g.adjacency.shape
    if r_slack != cfg.max_degree_with_slack:
        raise ValueError(
            f"adjacency width {r_slack} != max_degree_with_slack "
            f"{cfg.max_degree_with_slack} of the config"
        )
    idx = GraphIndex(g.dim, cfg, capacity=1, dtype=g.vectors.dtype, device=device,
                     **index_kwargs)
    idx.state = g
    if packed is not None:
        p = PackedState(**put(packed, _PACKED_DTYPES), r_pack=int(packed["r_pack"]))
        want = ((cap + 1) * n_wrows(p.r_pack, p.dp), 128)
        if tuple(p.rows.shape) != want or p.self_codes.shape[0] != cap:
            raise ValueError(
                f"packed table {tuple(p.rows.shape)} does not match capacity "
                f"{cap} (want rows {want})"
            )
        idx.packed = p
    if labels is not None:
        bits = np.ascontiguousarray(labels["bits"], np.uint32)
        if bits.ndim != 2 or bits.shape[0] != cap:
            raise ValueError(f"label bits {bits.shape} do not match capacity {cap}")
        ls = LabelSet(cap, labels["vocab"], bits.shape[1], device=device)
        ls.bits = torch.from_numpy(bits.view(np.int32).copy()).to(device)
        idx.labels = ls
    attach = {"pq": pq, "sq": sq, "minmax": minmax, "spherical": spherical}
    for name, arrays in attach.items():
        if arrays is None:
            continue
        for key, (attr, dt) in _ATTACH_TABLES[name].items():
            table = _tensor(arrays[key], dt, device)
            if table.shape[0] != cap:
                raise ValueError(f"{name} {key} has {table.shape[0]} rows, "
                                 f"not the capacity {cap}")
            setattr(idx, attr, table)
    f32 = lambda a: _tensor(a, torch.float32, device)  # noqa: E731
    if pq is not None:
        idx.pq = PQ(pivots=f32(pq["pivots"]), dim=int(pq["dim"]))
    if sq is not None:
        idx.sq = ScalarQuantizer(scale=f32(sq["scale"]), bias=f32(sq["bias"]),
                                 n_bits=int(sq["n_bits"]))
        idx.sq_bias2 = f32(sq["bias2"])
    if minmax is not None:
        idx.mm = MinMaxQuantizer()
    if spherical is not None:
        idx.sph = SphericalQuantizer(rotation=f32(spherical["rotation"]),
                                     n_bits=int(spherical["n_bits"]))
    idx.n = int(n)
    idx.n_deleted = int(n_deleted)
    idx.free_slots = [int(i) for i in free_slots]
    if cached_start is not None:
        idx._cached_start = _tensor(cached_start, torch.int32, device)
    idx._hbm_vectors_dropped = bool(hbm_vectors_dropped)
    return idx


def index_arrays(idx: GraphIndex) -> dict:
    """The keyword arguments of `graph_index_from_arrays` that rebuild port
    index ``idx`` (on another device, say), every array copied to numpy."""
    np_ = lambda a: a.cpu().numpy()  # noqa: E731
    packed = None
    if idx.packed is not None:
        packed = {f: np_(getattr(idx.packed, f)) for f in _PACKED_DTYPES}
        packed["r_pack"] = idx.packed.r_pack
    labels = None
    if idx.labels is not None:
        labels = {"vocab": dict(idx.labels.vocab),
                  "bits": np_(idx.labels.bits).view(np.uint32)}
    attach = {}
    for name, tables in _ATTACH_TABLES.items():
        first = getattr(idx, next(iter(tables.values()))[0])
        if first is not None:
            attach[name] = {key: np_(getattr(idx, attr)) for key, (attr, _) in tables.items()}
    if idx.pq is not None:
        attach["pq"].update(pivots=np_(idx.pq.pivots), dim=idx.pq.dim)
    if idx.sq is not None:
        attach["sq"].update(scale=np_(idx.sq.scale), bias=np_(idx.sq.bias),
                            n_bits=idx.sq.n_bits, bias2=np_(idx.sq_bias2))
    if idx.sph is not None:
        attach["spherical"].update(rotation=np_(idx.sph.rotation), n_bits=int(idx.sph.n_bits))
    start = idx._cached_start
    return dict(config=dataclasses.asdict(idx.config),
                graph={f: np_(getattr(idx.state, f)) for f in _GRAPH_DTYPES}
                | {"vectors": vectors_to_host(idx.state.vectors)},
                dtype=dtype_name(idx.dtype),
                packed=packed, n=idx.n, n_deleted=idx.n_deleted,
                free_slots=list(idx.free_slots), labels=labels,
                cached_start=None if start is None else np_(start),
                hbm_vectors_dropped=idx._hbm_vectors_dropped, **attach)


def sharded_index_from_arrays(
    *,
    config: dict,
    stacked: dict,
    ext,
    ns,
    starts,
    next_ext: int,
    n_deleted: int = 0,
    free_total: int = 0,
    packed: dict | None = None,
    labels: dict | None = None,
    dtype=None,
    device=None,
):
    """Build a port `ShardedGraphIndex` from the reference's sharded index.

    config: the `GraphConfig` fields (``metric`` as a `Metric` or its
    value); stacked: the stacked `GraphArrays` fields, ``[S, cap, ...]``
    numpy arrays; ext [S, cap], ns [S], starts [S, 1]: the external ids,
    high-water marks and start points; next_ext, n_deleted, free_total: the
    counters.  packed: the stacked `PackedState` fields (``[S, ...]``,
    ``proj`` / ``pscale`` / ``pbias2`` stacked too, as the reference holds
    them) plus ``r_pack``, or None; labels: ``{"labels_per_ext": list,
    "vocab": dict, "bits": [S, cap, n_words] uint32}``, or None.  dtype:
    the vectors' dtype, by default the array's own.  ``device``: one device
    for every shard (the CUDA card by default) or a sequence of one device
    per shard or a `Mesh`, as for `ShardedGraphIndex.load` (on a mesh, each
    worker is sent its shards' slices)."""
    from diskann_tpu_torch.parallel.sharded import ShardedGraphIndex, _record_placement

    cfg = dict(config)
    cfg["metric"] = Metric(cfg["metric"])
    cfg = GraphConfig(**cfg)
    ext = np.asarray(ext)
    n_shards, cap = ext.shape
    vectors = np.asarray(stacked["vectors"])
    if dtype is None:          # the array's own, as `vectors_from_host` reads it
        dtype = vectors_from_host(vectors[:1, :1]).dtype
    adjacency = np.asarray(stacked["adjacency"])
    if adjacency.shape != (n_shards, cap, cfg.max_degree_with_slack):
        raise ValueError(f"adjacency {adjacency.shape} does not match "
                         f"{n_shards} shards of {cap} x {cfg.max_degree_with_slack}")
    idx = ShardedGraphIndex(_record_placement(n_shards, device), vectors.shape[2], cfg,
                            cap_per_shard=1, dtype=dtype)
    idx._adopt_host({"vectors": vectors, "ext": ext, "starts": np.asarray(starts)}
                    | {k: np.asarray(stacked[k]) for k in _GRAPH_DTYPES})
    idx.ns = np.asarray(ns, np.int64).copy()
    idx.next_ext = int(next_ext)
    idx.n_deleted = int(n_deleted)
    idx._free_total = int(free_total)
    if packed is not None:
        idx._shards.adopt_packed([{f: np.asarray(packed[f])[s] for f in _PACKED_DTYPES}
                                  for s in range(n_shards)], int(packed["r_pack"]))
        idx._packed_dp = int(np.shape(packed["proj"])[-1])
    if labels is not None:
        idx._labels_per_ext = list(labels["labels_per_ext"])
        idx.label_vocab = dict(labels["vocab"])
        idx._shards.adopt_labels([np.asarray(labels["bits"])[s] for s in range(n_shards)])
    return idx
