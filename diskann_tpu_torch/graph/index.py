"""GraphIndex — the user-facing Vamana index (PyTorch port of
`diskann_tpu/graph/index.py`).

Ported: the build in both modes (`build(..., build_mode="full")`, the
default, walks full-precision vectors; "packed" keeps the packed int8
layout up to date and walks it) and `insert`, which takes freed slots off
the freelist (last freed, first reused) before fresh ones; streaming
deletes (`delete`: in-place repair of the in-neighbours by one of four
discovery methods and two repairs, `graph/delete.py`) and `consolidate`;
the start-point strategies (`set_start_strategy`); the packed re-attach
(`attach_packed`) and the quantized attachments (`attach_pq`, `attach_sq`,
`attach_minmax`, `attach_spherical`); search in modes "full"
(full-precision walk), "packed" (router entry points, packed hop loop,
full-precision rerank), "pq" / "sq" / "minmax" / "spherical" (the same
pipeline over the quantized codes) and "auto" (the exact flat scan of
`flat/index.py` over the live rows below `FLAT_AUTO_CROSSOVER`, else the
packed or full walk); and label-filtered search
(`attach_labels`, `search_filtered`: the exact posting-list scan, the
packed inline-beta walk and the full-precision inline walk with AdaptiveL
resume or multihop).  Range, paged and diversity-aware search live in
`graph/modes.py` and reach the index through `_scorer_for_mode`.  Every
tensor lives on the index's ``device`` (the CUDA card unless the caller
names another); the host only orchestrates batches, capacity, the freelist
and start points.

An insert does not encode its vectors into a quantized attachment: the
code tables only grow (as the reference's), so new rows score as code 0
until the attachment is made again; `service.py` encodes the rows it
inserts itself.
"""

from __future__ import annotations

import dataclasses
import traceback
from typing import NamedTuple

import numpy as np
import torch

from diskann_tpu_torch.devices import default_device
from diskann_tpu_torch.filters import LabelSet, compile_accept, parse_predicate
from diskann_tpu_torch.flat.index import (
    _flat_search, _flat_search_bf16, default_chunk, rerank_rows,
)
from diskann_tpu_torch.graph import delete as delete_mod
from diskann_tpu_torch.graph import packed as packed_mod
from diskann_tpu_torch.graph import state as graph_state
from diskann_tpu_torch.graph.build import insert_batch
from diskann_tpu_torch.graph.config import GraphConfig
from diskann_tpu_torch.graph.scorers import (
    full_precision_scorer, minmax_scorer, packed_router_starts, packed_scorer,
    pq_scorer, quantize_queries, smallest_ids, spherical_scorer, sq_aux_norms,
    sq_center_codes, sq_scorer,
)
from diskann_tpu_torch.graph.search import (
    beam_search, beam_search_scored, grow_resume_state, search_geometry,
)
from diskann_tpu_torch.io_.record import load_record, save_record
from diskann_tpu_torch.ops.distance import Metric, distance_to_set, squared_norms
from diskann_tpu_torch.ops.topk import sort_with
from diskann_tpu_torch.quant.minmax import MinMaxQuantizer
from diskann_tpu_torch.quant.pq import PQ, train_pq
from diskann_tpu_torch.quant.scalar import ScalarQuantizer, train_scalar
from diskann_tpu_torch.quant.spherical import SphericalQuantizer, train_spherical
from diskann_tpu_torch.trace import span, wait


# fat rows rebuilt per refresh_rows call in attach_packed: bounds the
# [rows, r_pack, dp] code gather (352 MB at dp=128)
_REFRESH_ROWS = 1 << 15

# rows patched per repair batch by `consolidate`
_CONSOLIDATE_ROWS = 1024

# entry-point strategies of `set_start_strategy`
_START_STRATEGIES = ("medoid", "first_vector", "random_samples",
                     "latin_hypercube", "random_vectors")

# query wire dtypes of `query_dtype` (the queries are rounded through the
# dtype, then computed on in float32); int8 takes the i8 wire instead
_QUERY_DTYPES = {"float16": torch.float16, "float32": torch.float32,
                 "bfloat16": torch.bfloat16}
# the names of the int8 query wire, as the reference takes them
_I8_WIRE = ("i8", "int8", "i8pack")

# search modes: the full-precision walk, and the walks over a compressed
# layout (each followed by a full-precision rerank)
_MODES = ("full", "packed", "pq", "sq", "minmax", "spherical")

# mode="auto" flat-vs-graph crossover, in live_n * dim elements: at or below
# it the exact masked flat scan answers, above it the graph walk.  Measured
# by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W, 8192 queries,
# k=10: at 100k x 768 (76.8M, inner product) the flat scan ran at 365,475
# QPS (recall 1.0) against the packed walk's 71,909; at 1M x 128 (128M, L2)
# the walk ran at 337,661 against the flat scan's 32,625.  The value sits
# between those two shapes.  The scan's cost follows rows, not elements
# (its per-row top-k selection): a batch over 600k x 128, also 76.8M
# elements, took 134.5 ms against the 1M walk's 24.3 ms, so at 128-d the
# walk wins well below this value.
FLAT_AUTO_CROSSOVER = 80_000_000


class SearchStats(NamedTuple):
    cmps: np.ndarray     # [B] distance computations per query
    hops: np.ndarray     # [B] nodes expanded per query
    result_count: np.ndarray


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _rerank(ids, queries, vectors, sq_norms, valid, metric: Metric, k: int):
    """Re-score candidate ids at full precision, sort, drop deleted ids,
    return the top k."""
    cap = vectors.shape[0]
    safe = ids.long().clamp(0, cap - 1)
    ok = (ids >= 0) & valid[safe]
    qsq = squared_norms(queries) if metric.needs_norms else None
    d = distance_to_set(queries, vectors[safe], metric,
                        x_sq_norms=sq_norms[safe], q_sq_norms=qsq)
    d, iid = sort_with(torch.where(ok, d, float("inf")), torch.where(ok, ids, -1))
    return d[:, :k], iid[:, :k]


def _filter_deleted(dists, ids, valid, k: int):
    """Drop deleted ids from sorted result lists and compact each row to its
    first k live entries."""
    cap = valid.shape[0]
    b = ids.shape[0]
    ok = (ids >= 0) & valid[ids.long().clamp(0, cap - 1)]
    rank = ok.cumsum(1) - 1
    slot = torch.where(ok & (rank < k), rank, k)   # column k is dropped
    out_d = torch.full((b, k + 1), float("inf"), dtype=dists.dtype,
                       device=dists.device)
    out_i = torch.full((b, k + 1), -1, dtype=ids.dtype, device=ids.device)
    out_d.scatter_(1, slot, dists)
    out_i.scatter_(1, slot, ids)
    return out_d[:, :k], out_i[:, :k]


def _member_scan(queries, member_ids, vectors, sq_norms, metric: Metric, k: int):
    """Exact top-k over an explicit member set (-1 padded): the posting-list
    evaluation of selective filtered queries.  A stable sort on distance
    keeps equal distances in member order."""
    cap = vectors.shape[0]
    ok = member_ids >= 0
    safe = member_ids.long().clamp(0, cap - 1)
    qsq = squared_norms(queries) if metric.needs_norms else None
    d = distance_to_set(queries, vectors[safe], metric,
                        x_sq_norms=sq_norms[safe], q_sq_norms=qsq)
    d, order = torch.sort(torch.where(ok[None, :], d, float("inf")), dim=1,
                          stable=True)
    kk = min(k, d.shape[1])
    b = d.shape[0]
    out_d = torch.full((b, k), float("inf"), device=d.device)
    out_i = torch.full((b, k), -1, dtype=torch.int32, device=d.device)
    out_d[:, :kk] = d[:, :kk]
    out_i[:, :kk] = member_ids[order[:, :kk]]
    return out_d, torch.where(torch.isfinite(out_d), out_i, -1)


def _router_dist(queries, rv, rsq, metric: Metric):
    """[B, d] queries x [S, d] router rows -> [B, S] float32 distances (the
    L2 form for every metric but inner product)."""
    q = queries.float()
    dots = q @ rv.float().T
    if metric == Metric.InnerProduct:
        return -dots
    return (q * q).sum(-1, keepdim=True) + rsq[None, :] - 2.0 * dots


def _router_topk_full_pre(rv, rsq, router_ids, queries, metric: Metric,
                          n_start: int):
    """Full-precision router over pre-gathered rows: the ``n_start``
    nearest router ids per query."""
    return smallest_ids(_router_dist(queries, rv, rsq, metric), router_ids,
                        n_start)


def _router_topk_packed_pre(rc, raux, proj, pscale, pbias2, router_ids,
                            queries, metric: Metric, n_start: int,
                            compute: str = "int8"):
    """Packed router over pre-gathered code rows: distances from each query
    to the ``rc [S, dp]`` router codes, then the ``n_start`` nearest ids.

    compute="int8": the query quantized to int8, an exact integer product
    (`packed_router_starts`).  compute="bf16": the scaled query against
    bf16-cast codes in bf16; entry points only need to be near-nearest."""
    if compute == "int8":
        return packed_router_starts(rc, raux, router_ids, proj, pscale, pbias2,
                                    queries, metric, n_start)
    if compute != "bf16":
        raise ValueError(f"unknown router compute {compute!r}")
    _, _, qb, qs = quantize_queries(queries, proj, pscale, pbias2, metric)
    dots = qs.bfloat16() @ rc.bfloat16().T
    if metric == Metric.InnerProduct:
        d = -dots
    else:
        qsq = (qb * qb).sum(-1, keepdim=True)
        d = qsq.bfloat16() + raux[None, :].bfloat16() - 2.0 * dots
    return smallest_ids(d, router_ids, n_start)


def _encode_i8pack(q: np.ndarray) -> np.ndarray:
    """Host-side int8 query wire (the reference's arithmetic): per-row
    symmetric scalar quantization (max-abs -> 127) with the float32 scale
    riding as 4 extra int8 columns -> [B, d+4] int8."""
    scale = np.abs(q).max(axis=1, keepdims=True).astype(np.float32) / 127.0
    scale = np.maximum(scale, 1e-12)
    qi = np.clip(np.rint(q / scale), -127, 127).astype(np.int8)
    return np.concatenate([qi, scale.view(np.int8)], axis=1)


def _decode_i8pack(q_wire: torch.Tensor, dim: int) -> torch.Tensor:
    """Device-side inverse of `_encode_i8pack` -> [B, d] float32 (codes
    times the row's scale)."""
    codes = q_wire[:, :dim].float()
    scale = q_wire[:, dim:dim + 4].contiguous().view(torch.float32)
    return codes * scale


def _query_wire(query_dtype) -> str | None:
    """The wire ``query_dtype`` names: None, a `_QUERY_DTYPES` key, or
    "i8pack" for the int8 wire (the strings of `_I8_WIRE`, or an int8
    numpy or torch dtype)."""
    if query_dtype is None:
        return None
    if isinstance(query_dtype, str) and query_dtype in _I8_WIRE:
        return "i8pack"
    if isinstance(query_dtype, torch.dtype):
        name = str(query_dtype).removeprefix("torch.")
    elif isinstance(query_dtype, str) and query_dtype == "bfloat16":
        # numpy knows this name only through ml_dtypes
        name = "bfloat16"
    else:
        name = np.dtype(query_dtype).name
    if name == "int8":
        return "i8pack"
    if name not in _QUERY_DTYPES:
        raise NotImplementedError(
            f"query_dtype={name!r}: the wires are float16, bfloat16, float32 and int8"
        )
    return name


def _round_queries(q: torch.Tensor, query_dtype) -> torch.Tensor:
    """Float32 queries as they arrive through the ``query_dtype`` wire:
    rounded through float16 / bfloat16 and back, or encoded on the host
    by `_encode_i8pack` and decoded on the queries' device; None keeps
    them."""
    wire = _query_wire(query_dtype)
    if wire is None:
        return q
    if wire == "i8pack":
        packed = torch.from_numpy(_encode_i8pack(q.cpu().numpy())).to(q.device)
        return _decode_i8pack(packed, q.shape[1])
    return q.to(_QUERY_DTYPES[wire]).float()


def _stats(cmps, hops, ids) -> SearchStats:
    return SearchStats(cmps=cmps, hops=hops, result_count=(ids >= 0).sum(axis=1))


class GraphIndex:
    """A dynamic Vamana graph index on one torch device."""

    #: Router distance math of packed search: "int8" (exact) or "bf16".
    router_compute: str = "int8"
    #: Cut each hop's candidates to the list width before the merge sort
    #: in the packed and quantized walks (`beam_search_scored`); exact up
    #: to equal-distance tie order.
    merge_trunc: bool = False

    def __init__(
        self,
        dim: int,
        config: GraphConfig | None = None,
        *,
        capacity: int = 1024,
        insert_batch_size: int = 1024,
        search_batch_size: int = 1024,
        build_backedge_src_cap: int = 64,
        dtype=torch.float32,
        device=None,
    ):
        """``dtype``: how the vectors are stored (`graph_state.VECTOR_DTYPES`:
        float32, float16, bfloat16, int8 or uint8, as a torch or numpy
        dtype or its name); every distance lifts them to float32."""
        self.config = config or GraphConfig()
        self.dim = dim
        self.dtype = graph_state.vector_dtype(dtype)
        self.device = default_device(device)
        self.insert_batch_size = insert_batch_size
        self.search_batch_size = search_batch_size
        # per-overfull-target cap on batch backedge sources entering the
        # re-prune pool (phase 3c)
        self.build_backedge_src_cap = build_backedge_src_cap
        self.n = 0
        self.n_deleted = 0
        # freed slots, reused last-in first-out by `insert`
        self.free_slots: list[int] = []
        self.packed: packed_mod.PackedState | None = None
        self.labels: LabelSet | None = None
        self.state = graph_state.alloc(
            _round_up(capacity, insert_batch_size), dim,
            self.config.max_degree_with_slack, self.dtype, device=self.device,
        )
        self.last_insert_stats: dict | None = None
        self.last_delete_stats: dict | None = None
        self._start_strategy = ("medoid", 1, 0)
        self._auto_start: torch.Tensor | None = None
        self._router_ids: torch.Tensor | None = None
        self._router_rows_cache: tuple | None = None
        self._pred_count_cache: dict = {}
        # a pinned start point (`TieredIndex.build_from_host`, `build_merged`)
        # wins over the strategy's; once the full vectors are dropped from
        # the device, only the codes serve traversal and routing
        self._cached_start: torch.Tensor | None = None
        self._hbm_vectors_dropped = False
        # mode="auto"'s bf16 copy of the vectors below n: (n, tensor)
        self._flat_bf16: tuple[int, torch.Tensor] | None = None
        # quantized attachments (`attach_*`); code tables have capacity rows
        self.pq = self.pq_codes = None
        self.sq = self.sq_codes = self.sq_bias2 = self.sq_aux = None
        self.mm = self.mm_codes = self.mm_lo = self.mm_step = self.mm_aux = None
        self.sph = self.sph_words = self.sph_norms = self.sph_cscale = None

    @property
    def n_live(self) -> int:
        return self.n - self.n_deleted

    def __len__(self) -> int:
        return self.n_live

    @property
    def metric(self) -> Metric:
        return self.config.metric

    # ------------------------------------------------------------------ build
    @classmethod
    def build(
        cls,
        vectors,
        config: GraphConfig | None = None,
        *,
        insert_batch_size: int = 1024,
        build_mode: str = "full",
        packed_dp: int = 64,
        capacity: int | None = None,
        device=None,
        **kwargs,
    ) -> "GraphIndex":
        """Bulk-build an index over `vectors` ([n, d] numpy array or tensor)
        with batched multi_insert.

        build_mode="full" walks the full-precision vectors for candidate
        generation; "packed" keeps the packed int8 layout (dp =
        `packed_dp`) up to date from the first batch on and walks it, and
        the layout then serves `search(mode="packed")`.  A tensor's device
        is the index's device unless `device` says otherwise; numpy input
        goes to the CUDA card by default.  ``dtype`` (kwargs) is the stored
        vector dtype, as for `GraphIndex`."""
        if build_mode not in ("full", "packed"):
            raise ValueError(f"unknown build_mode {build_mode!r}")
        if isinstance(vectors, torch.Tensor):
            device = device if device is not None else vectors.device
        else:
            vectors = np.asarray(vectors, np.float32)
        n, dim = vectors.shape
        idx = cls(dim, config, capacity=max(capacity or 0, n, insert_batch_size),
                  insert_batch_size=insert_batch_size, device=device, **kwargs)
        if build_mode == "packed":
            sample = vectors[: 1 << 16]
            if isinstance(sample, torch.Tensor):
                sample = sample.float().cpu().numpy()
            proj, pscale, pbias2 = packed_mod.train_packed(
                sample, min(packed_dp, dim), idx.config.metric, device=idx.device
            )
            idx.packed = packed_mod.alloc_packed(
                proj, pscale, pbias2, idx.state.capacity,
                idx.config.max_degree_with_slack,
            )
        idx.insert(vectors)
        return idx

    def _ensure_capacity(self, needed: int):
        cap = self.state.capacity
        if needed <= cap:
            return
        new_cap = _round_up(max(needed, int(cap * 1.5)), self.insert_batch_size)
        extra = new_cap - cap
        # every table is grown before any is replaced: an allocation that
        # fails leaves the index as it was
        grown = {"state": graph_state.grow(self.state, new_cap)}
        if self.packed is not None:
            grown["packed"] = packed_mod.grow_packed(self.packed, new_cap)
        if self.labels is not None:
            bits = torch.nn.functional.pad(self.labels.bits, (0, 0, 0, extra))
        # the code tables grow with empty rows (an insert encodes nothing)
        pad2 = lambda a: torch.nn.functional.pad(a, (0, 0, 0, extra))  # noqa: E731
        pad1 = lambda a, v=0.0: torch.nn.functional.pad(a, (0, extra), value=v)  # noqa: E731
        if self.pq is not None:
            grown["pq_codes"] = pad2(self.pq_codes)
        if self.sq is not None:
            grown |= {"sq_codes": pad2(self.sq_codes), "sq_aux": pad1(self.sq_aux)}
        if self.sph is not None:
            grown |= {"sph_words": pad2(self.sph_words), "sph_norms": pad1(self.sph_norms),
                      "sph_cscale": pad1(self.sph_cscale)}
        if self.mm is not None:
            grown |= {"mm_codes": pad2(self.mm_codes), "mm_aux": pad1(self.mm_aux),
                      "mm_lo": pad1(self.mm_lo), "mm_step": pad1(self.mm_step, 1.0)}
        for name, value in grown.items():
            setattr(self, name, value)
        if self.labels is not None:
            self.labels.bits, self.labels.capacity = bits, new_cap

    def set_start_strategy(self, strategy: str = "medoid", k: int = 1,
                           seed: int = 0) -> None:
        """Pick the walk's entry points (`graph_state.start_ids`): "medoid"
        (default), "first_vector", "random_samples", "latin_hypercube" or
        "random_vectors", with ``k`` points drawn from ``seed``.  Derived
        again after every insert and delete, like the medoid."""
        if strategy not in _START_STRATEGIES:
            raise ValueError(f"unknown start strategy {strategy!r}")
        if strategy == "random_vectors" and self._hbm_vectors_dropped:
            raise ValueError("random_vectors needs the full vectors on the device")
        self._start_strategy = (strategy, k, seed)
        self._invalidate_start()

    def _start(self) -> torch.Tensor:
        """The pinned start point if there is one, else the start points of
        the chosen strategy, [S] int32 ([-1] while the index is empty),
        cached until the next mutation."""
        if self._cached_start is not None:
            return self._cached_start
        if self.n_live <= 0:
            return torch.full((1,), -1, dtype=torch.int32, device=self.device)
        if self._auto_start is None:
            strat, k, seed = self._start_strategy
            if strat == "medoid":
                self._auto_start = graph_state.medoid(self.state, self.n_live)[None]
            else:
                self._auto_start = graph_state.start_ids(self.state, self.n,
                                                         strat, k, seed)
        return self._auto_start

    def _invalidate_start(self):
        self._auto_start = None
        self._router_ids = None
        self._router_rows_cache = None
        self._flat_bf16 = None  # mode="auto"'s scan cache follows mutations

    # ----------------------------------------------------------------- insert
    def insert(self, vectors) -> np.ndarray:
        """Insert vectors; returns their assigned internal ids.

        Slots freed by `delete` are taken first, last freed first, then
        fresh slots at the high-water mark ``n``; capacity grows only for
        the fresh ones.  The batch is cut into `insert_batch_size`
        minibatches, each committed by `graph/build.insert_batch`: on the
        packed layout (kept up to date, router entry points once enough
        rows are committed) when one is attached, else on the
        full-precision vectors.

        Each minibatch commits whole or not at all, as the reference's
        does: an exception inside one (out of device memory, a kernel
        build error, an interrupt) restores every row, cell and sum it
        wrote from its `RowJournal`, puts its freed slots and those of
        the minibatches after it back on the freelist in their order, and
        is re-raised; the minibatches before it stay committed, and so
        does a capacity already grown.  A sticky CUDA error leaves the
        device unusable and nothing can be restored.

        Each minibatch is traced as an ``insert.batch`` span (attributes
        ``offset`` and ``rows``, a root as in the reference), holding
        ``insert.candidates`` and ``insert.edges`` (`graph/build.py`);
        each refresh of the build-side router as an ``insert.router`` span
        (attribute ``committed``)."""
        vectors = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        if vectors.dim() == 1:
            vectors = vectors[None]
        if vectors.dim() != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"expected vectors of width {self.dim}, "
                             f"got shape {tuple(vectors.shape)}")
        m_total = vectors.shape[0]
        reuse = min(len(self.free_slots), m_total)
        slots = np.empty((m_total,), np.int64)
        if reuse:
            slots[:reuse] = self.free_slots[-reuse:][::-1]
            del self.free_slots[-reuse:]
        fresh = m_total - reuse
        slots[reuse:] = np.arange(self.n, self.n + fresh)

        bs = self.insert_batch_size
        cmps = torch.zeros((), dtype=torch.int64, device=self.device)
        hops = torch.zeros((), dtype=torch.int64, device=self.device)
        caches = (self._auto_start, self._router_ids, self._router_rows_cache,
                  self._flat_bf16)
        self._invalidate_start()  # one medoid refresh per insert call
        # Build-side router entry points, once >= 4 x router_size nodes are
        # committed; the sampled table is re-gathered every 16 batches.
        base_n = self.n
        r_size = self.config.router_size
        use_router = (self.packed is not None and r_size > 0
                      and self.config.router_starts > 0)
        router = None
        next_router_refresh = 0
        done = 0        # rows committed
        try:
            self._ensure_capacity(self.n + _round_up(fresh, bs))
            for bi, off in enumerate(range(0, m_total, bs)):
                chunk = vectors[off:off + bs]
                m = chunk.shape[0]
                schunk = torch.as_tensor(slots[off:off + bs].astype(np.int32),
                                         device=self.device)
                if m < bs:
                    # pad ragged batches: batch width sets the intra-batch and
                    # re-prune shapes, as in the reference
                    chunk = torch.nn.functional.pad(chunk, (0, 0, 0, bs - m))
                    schunk = torch.nn.functional.pad(schunk, (0, bs - m), value=-1)
                row_valid = torch.arange(bs, device=self.device) < m
                committed = base_n + off
                if use_router and committed >= 4 * r_size and bi >= next_router_refresh:
                    with span("insert.router", committed=committed):
                        rng_r = np.random.default_rng(0xD15C ^ committed)
                        rids = np.sort(rng_r.choice(committed, size=r_size, replace=False))
                        rids = torch.as_tensor(rids.astype(np.int32), device=self.device)
                        router = (self.packed.self_codes[rids.long()],
                                  self.packed.self_aux[rids.long()], rids)
                    next_router_refresh = bi + 16
                journal = graph_state.RowJournal()
                try:
                    with span("insert.batch", offset=off, rows=m):
                        _, _, stats = insert_batch(
                            self.state, schunk, chunk, row_valid, self._start(),
                            self.config, self.packed,
                            backedge_src_cap=self.build_backedge_src_cap,
                            router=router, journal=journal,
                        )
                except BaseException as exc:
                    # free the failed step's temporaries (its frames' locals)
                    # before the restore, which runs under the same pressure
                    traceback.clear_frames(exc.__traceback__)
                    journal.restore()
                    raise
                journal.drop()
                self.n = max(self.n, int(slots[off:off + m].max()) + 1)
                done = off + m
                cmps += stats.cmps.sum()
                hops += stats.hops.sum()
        except BaseException:
            if done == 0:   # nothing committed: the start and router caches hold
                (self._auto_start, self._router_ids, self._router_rows_cache,
                 self._flat_bf16) = caches
            raise
        finally:
            # the freed slots of the minibatches not committed go back
            used = min(done, reuse)
            self.n_deleted -= used
            self.free_slots.extend(slots[used:reuse][::-1].tolist())
        self.last_insert_stats = {"cmps": int(cmps), "hops": int(hops)}
        return slots

    # ----------------------------------------------------------------- attach
    def attach_packed(self, *, dp: int | None = 64, sigma: float = 4.0,
                      writable: bool = True, refresh_block: int = _REFRESH_ROWS,
                      spill: bool | None = None) -> None:
        """(Re)build the packed search layout: PCA-project the vectors to
        ``dp`` dims, quantize to int8, and write every node's fat row,
        ``refresh_block`` rows per `refresh_rows` call.

        ``writable`` is taken and changes nothing: every table stays
        writable, since the reference's read-only guard above 2^31 words
        exists because its scatters index in int32, and the port indexes
        in int64.  ``spill`` is taken and changes nothing: the reference
        spills its device state to the host around a big allocation to
        defragment TPU memory, which the port does not do."""
        del writable, spill
        sample = self.state.vectors[: min(1 << 16, self.n)].float().cpu().numpy()
        proj, pscale, pbias2 = packed_mod.train_packed(
            sample, min(dp or self.dim, self.dim), self.config.metric,
            sigma=sigma, device=self.device,
        )
        # free the previous layout before allocating the new multi-GB table
        self.packed = None
        self._router_rows_cache = None
        cap = self.state.capacity
        p = packed_mod.alloc_packed(
            proj, pscale, pbias2, cap, self.config.max_degree_with_slack
        )
        codes, aux = packed_mod.encode(p, self.state.vectors[: self.n],
                                       self.config.metric)
        packed_mod.set_self_codes(
            p, torch.arange(self.n, device=self.device), codes, aux
        )
        del codes, aux
        for off in range(0, cap, refresh_block):
            rows = torch.arange(off, min(off + refresh_block, cap),
                                device=self.device)
            packed_mod.refresh_rows(p, self.state.adjacency, rows)
        self.packed = p

    def attach_pq(self, pq=None, *, n_chunks: int = 32, n_centers: int = 256,
                  seed: int = 0, generator: torch.Generator | None = None) -> None:
        """Attach a product quantizer (``pq``, or one trained here on the
        vectors with ``generator`` or ``seed``) and encode every row below
        ``n``: enables ``search(mode="pq")``.  n_centers=16 is 4-bit PQ."""
        vecs = self.state.vectors[: self.n].float()
        if pq is None:
            pq = train_pq(vecs, n_chunks=n_chunks, n_centers=n_centers,
                          seed=seed, generator=generator)
        pq = pq._replace(pivots=pq.pivots.to(self.device))
        codes = torch.zeros((self.state.capacity, pq.n_chunks), dtype=torch.uint8,
                            device=self.device)
        codes[: self.n] = pq.encode(vecs)
        self.pq, self.pq_codes = pq, codes

    def attach_sq(self, *, n_bits: int = 8, sigma: float = 4.0) -> None:
        """Train an int8 scalar quantizer on the vectors and encode every
        row below ``n``: enables ``search(mode="sq")``."""
        vecs = self.state.vectors[: self.n].float()
        sq = train_scalar(vecs, n_bits=n_bits, sigma=sigma)
        codes = torch.full((self.state.capacity, self.dim), 128, dtype=torch.uint8,
                           device=self.device)
        codes[: self.n] = sq.encode(vecs)
        self.sq = sq
        self.sq_codes, self.sq_bias2 = sq_center_codes(codes, sq.scale, sq.bias)
        self.sq_aux = sq_aux_norms(self.sq_codes, sq.scale)

    def attach_minmax(self) -> None:
        """Encode every row below ``n`` with the training-free per-vector
        MinMax quantizer: enables ``search(mode="minmax")``."""
        mm = MinMaxQuantizer()
        cap, n = self.state.capacity, self.n
        codes, lo, step = mm.encode(self.state.vectors[:n])
        dec = mm.decode(codes, lo, step)
        self.mm = mm
        self.mm_codes = torch.zeros((cap, self.dim), dtype=torch.int8, device=self.device)
        self.mm_codes[:n] = (codes.to(torch.int32) - 128).to(torch.int8)
        self.mm_lo = torch.zeros(cap, device=self.device)
        self.mm_lo[:n] = lo
        self.mm_step = torch.ones(cap, device=self.device)
        self.mm_step[:n] = step
        self.mm_aux = torch.zeros(cap, device=self.device)
        self.mm_aux[:n] = (dec * dec).sum(1)

    def attach_spherical(self, *, n_bits: int = 4, seed: int = 0,
                         generator: torch.Generator | None = None) -> None:
        """Draw a spherical quantizer's rotation (``generator`` or
        ``seed``) and bit-pack every row below ``n``: enables
        ``search(mode="spherical")``."""
        sph = train_spherical(self.dim, n_bits=n_bits, seed=seed,
                              generator=generator, device=self.device)
        pc = sph.pack(sph.encode(self.state.vectors[: self.n]))
        cap, n = self.state.capacity, self.n
        self.sph = sph
        self.sph_words = torch.zeros((cap, pc.words.shape[1]), dtype=torch.int32,
                                     device=self.device)
        self.sph_words[:n] = pc.words
        self.sph_norms = torch.zeros(cap, device=self.device)
        self.sph_norms[:n] = pc.norms
        self.sph_cscale = torch.zeros(cap, device=self.device)
        self.sph_cscale[:n] = pc.cscale

    def drop_vectors(self) -> None:
        """Pin the start point, then free the full-precision vectors on the
        device (a [1, d] placeholder stays): the tiered index's graph,
        whose walks read only the codes and whose full rows live on the
        host.  Searches that rerank on the device need the vectors."""
        self._cached_start = self._start()
        self._router_rows_cache = None
        self.state = self.state._replace(
            vectors=torch.zeros((1, self.dim), dtype=self.dtype, device=self.device),
            sq_norms=torch.zeros((1,), device=self.device),
        )
        self._hbm_vectors_dropped = True

    def _scorer_for_mode(self, mode: str):
        """(ScorerDef, scorer data, expand_r) of a search mode: the scorer
        the walk of that mode runs over."""
        metric = self.config.metric
        need = {"packed": self.packed, "pq": self.pq, "sq": self.sq,
                "minmax": self.mm, "spherical": self.sph}
        if mode in need and need[mode] is None:
            raise ValueError(f"mode={mode!r} needs attach_{mode}() first")
        if mode == "full":
            sdef, sdata = full_precision_scorer(self.state.vectors,
                                                self.state.sq_norms, metric)
        elif mode == "packed":
            sdef, sdata = packed_scorer(self.packed, metric)
            return sdef, sdata, self.packed.r_pack
        elif mode == "pq":
            sdef, sdata = pq_scorer(self.pq_codes, self.pq.pivots, metric)
        elif mode == "sq":
            sdef, sdata = sq_scorer(self.sq_codes, self.sq.scale, self.sq_bias2,
                                    self.sq_aux, metric)
        elif mode == "minmax":
            sdef, sdata = minmax_scorer(self.mm_codes, self.mm_lo, self.mm_step,
                                        self.mm_aux, metric)
        elif mode == "spherical":
            sdef, sdata = spherical_scorer(
                self.sph_words, self.sph_norms, self.sph_cscale, self.sph.rotation,
                int(self.sph.rotation.shape[1]), int(self.sph.n_bits), metric)
        else:
            raise ValueError(f"unknown search mode {mode!r}")
        return sdef, sdata, None

    # ----------------------------------------------------------------- search
    def _queries(self, queries, query_dtype=None) -> torch.Tensor:
        """[B, d] float32 queries on the index's device, rounded through
        ``query_dtype`` (`_round_queries`)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        return _round_queries(q[None] if q.dim() == 1 else q, query_dtype)

    def _router_ids_live(self, mode: str) -> torch.Tensor | None:
        """The sampled live-id router set (None when the router is off, the
        index is too small, or a pinned start serves a walk other than the
        packed one)."""
        cfg = self.config
        size = min(cfg.router_size, self.n_live // 4)
        if cfg.router_size <= 0 or size < 64:
            return None
        if self._cached_start is not None and mode != "packed":
            return None
        if self._router_ids is None:
            valid = self.state.valid[: self.n].cpu().numpy()
            live = np.nonzero(valid)[0]
            rng = np.random.default_rng(0xD15C)
            sel = rng.choice(live, size=min(size, len(live)), replace=False)
            self._router_ids = torch.as_tensor(
                np.sort(sel).astype(np.int32), device=self.device
            )
        return self._router_ids

    def _router_rows(self, packed: bool) -> tuple:
        """Router rows gathered once per (source tensors, id set): packed
        code rows, or full-precision vectors and norms."""
        rid = self._router_ids
        src = self.packed if packed else self.state
        c = self._router_rows_cache
        if c is not None and c[0] is src and c[1] is rid:
            return c[2]
        if packed:
            pk = self.packed
            rows = (pk.self_codes[rid.long()], pk.self_aux[rid.long()],
                    pk.proj, pk.pscale, pk.pbias2)
        else:
            rows = (self.state.vectors[rid.long()], self.state.sq_norms[rid.long()])
        self._router_rows_cache = (src, rid, rows)
        return rows

    def _packed_router(self, mode: str) -> bool:
        """Whether the router of ``mode`` scores the packed self-codes (the
        packed walk, or any walk once the full vectors are dropped)."""
        return mode == "packed" or self._hbm_vectors_dropped

    def _n_start(self, router_ids, router_starts) -> int:
        """Router entry points per query (None/0 = the config default),
        capped at the router table size."""
        ns = router_starts if router_starts else self.config.router_starts
        if ns < 1:
            raise ValueError(f"router_starts must be >= 1, got {ns}")
        return min(ns, int(router_ids.shape[0])) if router_ids is not None else ns

    def search(
        self,
        queries,
        k: int = 10,
        *,
        l_search: int | None = None,
        beam_width: int | None = None,
        mode: str = "full",
        rerank_l: int | None = None,
        max_hops: int | None = None,
        query_dtype=None,
        router_starts: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray, SearchStats]:
        """k-NN search.  Returns (dists [B,k], ids [B,k], stats) as numpy
        arrays.

        mode="auto": the exact flat scan over the live rows
        (`_flat_auto_search`) while ``n_live * dim <= FLAT_AUTO_CROSSOVER``
        and the vectors are on the device, else "packed" when a packed
        layout is attached and "full" otherwise.
        mode="full": full-precision walk with the scored-id ring.
        mode="packed" (packed int8 walk, `fatrow_expand`), "pq", "sq",
        "minmax" or "spherical" (walks over the attached codes): router
        entry points (packed ones for "packed", full-precision ones for the
        others), the hop loop (the best-list dedup at W > 1 or in packed
        mode, else the ring), then a full-precision rerank of the top
        `rerank_l` candidates (None: all L).  max_hops: cap the hop loop.
        query_dtype: the queries' wire: np.float16 or bfloat16 rounds them
        through that type first; "i8" / "int8" / "i8pack" / np.int8 takes
        the int8 wire (`_encode_i8pack`), on every route (the reference's
        full route casts to int64 or int8 there instead, which truncates
        the queries).
        router_starts: per-query router entry points (None = config
        default).

        Traced as a ``search`` span (attributes ``mode`` and ``queries``)
        holding each query batch's ``search.router``, ``search.walk`` and
        ``search.rerank`` (`trace.py`)."""
        with span("search", mode=mode,
                  queries=1 if np.ndim(queries) == 1 else len(queries)):
            if mode == "auto":
                if (not self._hbm_vectors_dropped
                        and self.n_live * self.dim <= FLAT_AUTO_CROSSOVER):
                    return self._flat_auto_search(self._queries(queries), k)
                mode = "packed" if self.packed is not None else "full"
            if mode not in _MODES:
                raise ValueError(f"unknown search mode {mode!r}")
            scorer = self._scorer_for_mode(mode)
            q = self._queries(queries, query_dtype)
            l = l_search if l_search is not None else max(k, self.config.l_build)
            l = max(l, k)
            w = beam_width if beam_width is not None else self.config.beam_width
            router_ids = self._router_ids_live(mode)
            n_start = self._n_start(router_ids, router_starts)
            router_rows = (self._router_rows(self._packed_router(mode))
                           if router_ids is not None else None)
            bs = self.search_batch_size
            if mode == "full":
                parts = [self._full_search_batch(q[off:off + bs], k, l, w, max_hops,
                                                 router_ids, router_rows, n_start)
                         for off in range(0, q.shape[0], bs)]
            else:
                parts = [self._quant_search_batch(q[off:off + bs], mode, scorer, k, l, w,
                                                  rerank_l, max_hops, router_ids,
                                                  router_rows, n_start)
                         for off in range(0, q.shape[0], bs)]
            with wait("sync"):
                fd, fi, cmps, hops = (torch.cat(t).cpu().numpy() for t in zip(*parts))
            return fd, fi, _stats(cmps, hops, fi)

    def _flat_auto_search(self, q, k: int):
        """mode="auto" below the crossover: the exact scan over the rows
        below ``n`` under the validity mask, so deleted slots never surface
        (`flat/index.py`: the bf16 shortlist and float32 rerank, or the
        float32 scan for L1).  Stats: no hops, ``n_live`` comparisons."""
        metric = self.config.metric
        st = self.state
        n, b = self.n, q.shape[0]
        chunk = default_chunk(metric, max(n, 1))
        if metric == Metric.L1:
            d, i = _flat_search(q, st.vectors, st.sq_norms, st.valid, metric=metric,
                                k=k, chunk=chunk, n=n)
        else:
            kc = min(max(4 * k, 64), st.capacity)
            if self._flat_bf16 is None or self._flat_bf16[0] != n:
                self._flat_bf16 = (n, st.vectors[:n].to(torch.bfloat16))
            d, i = _flat_search_bf16(
                q, self._flat_bf16[1], st.vectors, st.sq_norms, st.valid, metric=metric,
                k=k, kc=kc, chunk=chunk, n=n, qc=rerank_rows(b, kc, self.dim))
        with wait("sync"):
            fd, fi = d.cpu().numpy(), i.cpu().numpy()
        return fd, fi, _stats(np.full((b,), self.n_live, np.int32),
                              np.zeros((b,), np.int32), fi)

    def _entry_points(self, q, mode, router_ids, router_rows, n_start):
        """Each query's walk entry points: its ``n_start`` nearest router
        ids (`_router_topk_packed_pre` or `_router_topk_full_pre`), or the
        start point when there is no router.  A ``search.router`` span."""
        with span("search.router"):
            if router_ids is None:
                return self._start()
            if self._packed_router(mode):
                return _router_topk_packed_pre(*router_rows, router_ids, q, self.metric,
                                               n_start, compute=self.router_compute)
            return _router_topk_full_pre(*router_rows, router_ids, q, self.metric, n_start)

    def _quant_search_batch(self, q, mode, scorer, k, l, w, rl, mh, router_ids,
                            router_rows, n_start):
        """One query batch of a compressed walk: router entry points, the
        hop loop over the mode's scorer, full-precision rerank of the top
        `rl` candidates."""
        cfg = self.config
        metric = cfg.metric
        st = self._entry_points(q, mode, router_ids, router_rows, n_start)
        sdef, sdata, expand_r = scorer
        with span("search.walk"):
            res = beam_search_scored(
                sdef, sdata, self.state.adjacency, st, q,
                l_search=l, beam_width=w, max_hops=mh or cfg.max_hops,
                history_capacity=cfg.history_capacity(l),
                dedup="list" if (mode == "packed" or w > 1) else "ring",
                expand_r=expand_r, merge_trunc=self.merge_trunc,
            )
        rl_eff = min(rl, l) if rl else l
        with span("search.rerank"):
            fd, fi = _rerank(res.ids[:, :rl_eff], q, self.state.vectors,
                             self.state.sq_norms, self.state.valid, metric, k)
        return fd, fi, res.cmps, res.hops

    def _full_search_batch(self, q, k, l, w, mh, router_ids, router_rows, n_start):
        """One query batch of the full-precision walk (ring dedup, sized by
        `GraphConfig.history_capacity`)."""
        cfg = self.config
        st = self._entry_points(q, "full", router_ids, router_rows, n_start)
        with span("search.walk"):
            res = beam_search(
                self.state.vectors, self.state.sq_norms, self.state.adjacency, st, q,
                metric=cfg.metric, l_search=l, beam_width=w,
                max_hops=mh or cfg.max_hops, history_capacity=cfg.history_capacity(l),
            )
        with span("search.rerank"):
            fd, fi = _filter_deleted(res.dists, res.ids, self.state.valid, k)
        return fd, fi, res.cmps, res.hops

    # ---------------------------------------------------------------- filters
    def attach_labels(self, labels_per_point: list[list[str]]) -> None:
        """Assign labels to points 0..len-1 (JSONL-ingestion shape)."""
        self.labels = LabelSet.from_lists(
            labels_per_point, capacity=self.state.capacity, device=self.device
        )
        # a new label set restarts at version 0, so the count cache keyed
        # on the version must go with the old set
        self._pred_count_cache = {}

    def _accept_all(self, accept_fn) -> torch.Tensor:
        """[cap] bool: the live ids that match (the posting list)."""
        cap = self.state.capacity
        ids = torch.arange(cap, dtype=torch.int32, device=self.device)
        return accept_fn(self.labels.bits, ids, self.state.valid) & self.state.valid

    def _predicate_count(self, predicate, accept_fn) -> int:
        """|{live ids matching predicate}|, cached per (predicate, label
        version, live set): one host sync per predicate, not per call."""
        key = (repr(predicate), self.labels.version, self.n, self.n_deleted)
        cnt = self._pred_count_cache.get(key)
        if cnt is None:
            cnt = int(self._accept_all(accept_fn).sum())
            self._pred_count_cache = {key: cnt}   # keep it tiny
        return cnt

    def search_filtered(
        self,
        queries,
        predicate,
        k: int = 10,
        *,
        l_search: int | None = None,
        beam_width: int | None = None,
        filter_beta: float | None = None,
        adaptive_l: bool = True,
        max_l_scale: int = 8,
        method: str = "inline",
        scan_threshold: int | None = None,
        mode: str = "full",
        rerank_l: int | None = None,
        max_hops: int | None = None,
        query_dtype=None,
    ):
        """Label-filtered k-NN.  Returns (dists [B,k], ids [B,k], stats).

        method="inline": one navigation walk over all nodes with matching
        distances biased by beta (default 0.5), plus a matched-only result
        list; AdaptiveL widens L when a query's list came back short.
        method="multihop": accept-only navigation with a two-hop expansion
        through rejected nodes (mode="full" only; the packed walk is
        inline).  method="prefilter": always the exact posting-list scan.
        scan_threshold: largest member count that takes the scan (default
        max(4*l_search, 512, min(cap//16, 65536)) for inline); 0 forces
        the walk.
        mode="packed": the production walk — router entry points, packed
        int8 hops with the inline filter, full-precision rerank of the top
        `rerank_l` matches; `max_hops` and `query_dtype` apply here.  Every
        other mode ("full" and the quantized ones) takes the full-precision
        route, as in the reference.  As in the reference, the scan and the
        full route read the float32 queries, and the full route walks up
        to `config.max_hops`."""
        if self.labels is None:
            raise ValueError("attach_labels first")
        if method not in ("inline", "multihop", "prefilter"):
            raise ValueError(f"unknown method {method!r}")
        if mode not in _MODES:
            raise ValueError(f"unknown search mode {mode!r}")
        if isinstance(predicate, str):
            predicate = parse_predicate(predicate)
        accept_fn = compile_accept(predicate, self.labels.vocab, self.state.capacity)
        beta = filter_beta if filter_beta is not None else 0.5
        q = self._queries(queries)
        cfg = self.config
        l0 = l_search if l_search is not None else max(k, cfg.l_build)
        w = beam_width if beam_width is not None else cfg.beam_width

        # ---- selective predicates: the exact posting-list scan ----
        cnt = None
        # without the full vectors on the device there is no scan to route to
        if method in ("inline", "prefilter") and not self._hbm_vectors_dropped:
            cnt = self._predicate_count(predicate, accept_fn)
            cap = self.state.capacity
            if scan_threshold is not None:
                threshold = scan_threshold
            elif method == "inline":
                threshold = max(4 * l0, 512, min(cap // 16, 1 << 16))
            else:
                threshold = cap
            if cnt <= threshold:
                return self._scan_filtered(q, accept_fn, k, cnt)

        if mode == "packed":
            if self.packed is None:
                raise ValueError("attach_packed first for mode='packed'")
            live = max(self.n_live, 1)
            return self._search_filtered_packed(
                _round_queries(q, query_dtype), accept_fn, k, l0, w,
                max_hops or cfg.max_hops, beta, rerank_l or l0, adaptive_l,
                max_l_scale, selectivity=cnt / live if cnt is not None else None,
            )
        return self._search_filtered_full(q, accept_fn, k, l0, w, beta, method,
                                          adaptive_l, max_l_scale)

    def _scan_filtered(self, q, accept_fn, k: int, cnt: int):
        """Exact top-k over the predicate's members, padded with -1 to a
        power of two >= 64; queries go in chunks that keep the [chunk,
        members] distance matrix near 2^27 entries."""
        members = torch.nonzero(self._accept_all(accept_fn)).squeeze(1)
        pad = max(1 << int(np.ceil(np.log2(max(members.shape[0], 1)))), 64)
        mem = torch.full((pad,), -1, dtype=torch.int32, device=self.device)
        mem[: members.shape[0]] = members.to(torch.int32)
        b = q.shape[0]
        qc = max(min(b, (1 << 27) // pad), 64)
        parts = [_member_scan(q[off:off + qc], mem, self.state.vectors,
                              self.state.sq_norms, self.config.metric, k)
                 for off in range(0, b, qc)]
        fd, fi = (torch.cat(t).cpu().numpy() for t in zip(*parts))
        return fd, fi, _stats(np.full((b,), cnt, np.int32),
                              np.zeros((b,), np.int32), fi)

    def _search_filtered_packed(self, q, accept_fn, k, l, w, mh, beta, rl,
                                adaptive_l, max_l_scale, selectivity=None):
        """The production filtered walk, sub-batched like `search`.

        selectivity (the matched share of live points) widens the first
        pass: a 1-6% predicate fills the matched list with plausible but
        wrong results, so the found < k retry would never fire.  AdaptiveL
        then walks only the short queries again at max_l_scale x L and
        writes them back to their rows."""
        if selectivity is not None and selectivity > 0:
            if selectivity < 0.012:
                scale = min(4, max_l_scale)
            elif selectivity < 0.06:
                scale = min(2, max_l_scale)
            else:
                scale = 1
            if scale > 1:
                l = min(l * scale, 1024)
                rl = min(rl * scale, l)
                mh = min(mh * scale, 48)
        router_ids = self._router_ids_live("packed")
        n_start = self._n_start(router_ids, None)
        router_rows = self._router_rows(True) if router_ids is not None else None
        bs = self.search_batch_size

        def run_pass(l_cur, rl_cur, qset):
            parts = [
                self._filtered_packed_batch(
                    qset[off:off + bs], accept_fn, k, l_cur, w, mh, beta,
                    rl_cur, router_ids, router_rows, n_start)
                for off in range(0, qset.shape[0], bs)
            ]
            return [torch.cat(t) for t in zip(*parts)]

        out_d, out_i, cmps, hops = run_pass(l, min(rl, l), q)
        short = (out_i >= 0).sum(1) < k
        if adaptive_l and max_l_scale > 1 and bool(short.any()):
            l1 = min(l * max_l_scale, 1024)
            d2, i2, c2, h2 = run_pass(l1, min(max(rl, k), l1), q[short])
            out_d[short], out_i[short] = d2, i2
            cmps[short] += c2
            hops[short] += h2
        fd, fi, cmps, hops = (t.cpu().numpy() for t in (out_d, out_i, cmps, hops))
        return fd, fi, _stats(cmps, hops, fi)

    def _filtered_packed_batch(self, q, accept_fn, k, l, w, mh, beta, rl,
                               router_ids, router_rows, n_start):
        """One query batch of the filtered walk: router entry points, packed
        hops (K1) with the inline filter, rerank of the top `rl` matches."""
        metric = self.config.metric
        st = self._entry_points(q, "packed", router_ids, router_rows, n_start)
        sdef, sdata = packed_scorer(self.packed, metric)
        res = beam_search_scored(
            sdef, sdata, self.state.adjacency, st, q,
            l_search=l, beam_width=w, max_hops=mh, dedup="list",
            expand_r=self.packed.r_pack, accept_fn=accept_fn,
            accept_data=self.labels.bits, filter_beta=beta,
            merge_trunc=self.merge_trunc,
        )
        fd, fi = _rerank(res.match_i[:, :rl], q, self.state.vectors,
                         self.state.sq_norms, self.state.valid, metric, k)
        return fd, fi, res.cmps, res.hops

    def _search_filtered_full(self, q, accept_fn, k, l0, w, beta, method,
                              adaptive_l, max_l_scale):
        """The full-precision filtered walk from the medoid, all queries in
        one batch.  AdaptiveL resumes the first pass's scratch at a wider
        window (grown list and ring, frontier re-seeded from the ring)
        instead of searching again from the start."""
        cfg = self.config
        sdef, sdata = full_precision_scorer(self.state.vectors,
                                            self.state.sq_norms, cfg.metric)
        start = self._start()

        def run(l, resume=None):
            return beam_search_scored(
                sdef, sdata, self.state.adjacency, start, q,
                l_search=l, beam_width=w, max_hops=cfg.max_hops,
                history_capacity=cfg.history_capacity(l),
                accept_fn=accept_fn, accept_data=self.labels.bits,
                filter_beta=beta, filter_mode=method,
                resume_state=resume, return_state=True,
                reseed_ring=resume is not None,
            )

        res, scratch = run(l0)
        found = (res.match_i >= 0).sum(1)
        if adaptive_l and bool((found < k).any()):
            # specificity = matches found per node scored; rescale L
            # log-style from it, never below l0
            spec = max(float(found.sum()) / max(float(res.cmps.sum()), 1.0), 1e-4)
            if spec >= 0.5:
                scale = 1
            elif spec >= 0.1:
                scale = 2
            else:
                scale = min(int(2 ** int(np.ceil(-np.log10(spec)))), max_l_scale)
            l1 = max(min(l0 * scale, 1024), l0)
            if scale > 1 and l1 > l0:
                l_tot, _, h_new = search_geometry(
                    l_search=l1, reserve=0, beam_width=w,
                    r=self.state.adjacency.shape[1], s=start.shape[-1],
                    history_capacity=cfg.history_capacity(l1),
                )
                res, scratch = run(l1, resume=grow_resume_state(scratch, l_tot, h_new))
        fd, fi = _filter_deleted(res.match_d, res.match_i, self.state.valid, k)
        fi = fi.cpu().numpy()
        return (fd.cpu().numpy(), fi,
                _stats(res.cmps.cpu().numpy(), res.hops.cpu().numpy(), fi))

    # ----------------------------------------------------------------- delete
    def delete(self, ids, *, method: str = "scan", k_value: int = 16,
               l_value: int | None = None, repair: str = "prune",
               max_dead: int = 4, repl_cap: int = 16) -> None:
        """In-place delete (`graph/delete.inplace_delete`): repair the rows
        that refer to the deleted nodes, clear the nodes' rows, and put
        their slots on the freelist for later inserts.  Ids already
        deleted, out of range or repeated are skipped.

        method: "scan" (every live row that refers to a deleted id; no
        dangling reference survives), "one_hop", "two_hop_one_hop" or
        "visited_topk" (``k_value`` replacements from an ``l_value``-wide
        search).  repair: "prune" RobustPrunes each patched row back to R;
        "fill" drops the dead entries and tops the row up with the nearest
        replacements, with no occlusion scan.  The counts of the call are
        in ``last_delete_stats``.  The call commits whole or not at all
        (`_commit_whole`), so a retry after a failure deletes the same ids.
        Traced as a ``delete`` span (attributes ``method``, ``repair`` and
        ``rows``, the rows deleted) holding ``delete.repair`` and
        ``delete.refresh``."""
        with span("delete", method=method, repair=repair) as rec:
            self.last_delete_stats = self._commit_whole(
                lambda journal, refreshed: delete_mod.inplace_delete(
                    self, ids, method=method, k_value=k_value, l_value=l_value,
                    repair=repair, max_dead=max_dead, repl_cap=repl_cap,
                    journal=journal, refreshed=refreshed))
            self._invalidate_start()
            if rec is not None:
                rec["attributes"]["rows"] = self.last_delete_stats["deleted"]

    def consolidate(self) -> None:
        """Cleanup sweep: prune-repair every live row that still refers to
        a deleted node (the approximate delete methods can leave some),
        clear the deleted nodes' rows, and refresh the packed rows of both
        when a packed layout is attached.  Commits whole or not at all
        (`_commit_whole`)."""
        self._commit_whole(self._consolidate)

    def _consolidate(self, journal: graph_state.RowJournal, refreshed: list) -> None:
        st = self.state
        affected = torch.nonzero(delete_mod.rows_referencing_deleted(st)).squeeze(1)
        delete_mod.save_rows(journal, st, affected)
        for off in range(0, affected.shape[0], _CONSOLIDATE_ROWS):
            delete_mod.patch_rows(st, affected[off:off + _CONSOLIDATE_ROWS],
                                  self.config)
        # deleted rows that still hold entries (e.g. carried across)
        stale = torch.cat([affected, torch.nonzero(
            ~st.valid & (st.adjacency >= 0).any(1)).squeeze(1)])
        delete_mod.drop_deleted_rows(st, journal)
        if self.packed is not None:
            delete_mod.refresh_chunks(self.packed, st.adjacency, stale,
                                      _CONSOLIDATE_ROWS, refreshed)

    def _commit_whole(self, call):
        """``call(journal, refreshed)``, committed whole or not at all.
        Its writers save what they overwrite in ``journal`` and put the
        fat-row chunks they refresh on ``refreshed``.  On any exception
        (out of device memory, a kernel build error, an interrupt) the
        journal is restored, the refreshed fat rows are rebuilt from the
        restored adjacency (`delete.rebuild_refreshed`), the freelist,
        ``n_deleted`` and the start cache are put back, and the exception
        is re-raised.  A sticky CUDA error leaves the device unusable and
        nothing can be restored."""
        journal = graph_state.RowJournal()
        refreshed: list = []
        # visited_topk's walk derives the start from the marked state
        host = len(self.free_slots), self.n_deleted, self._auto_start
        try:
            out = call(journal, refreshed)
        except BaseException as exc:
            # free the failed step's temporaries (its frames' locals)
            # before the undo, which runs under the same pressure
            traceback.clear_frames(exc.__traceback__)
            journal.restore()
            if self.packed is not None:
                delete_mod.rebuild_refreshed(self.packed, self.state.adjacency, refreshed)
            del self.free_slots[host[0]:]
            _, self.n_deleted, self._auto_start = host
            raise
        journal.drop()
        return out

    # -------------------------------------------------------------- save/load
    def save(self, path: str) -> None:
        """Persist the index with every attachment (packed layout, PQ, SQ,
        spherical and MinMax codes, labels, the pinned start) as the JAX
        package's record (`io_/record.py`): ``manifest.json`` plus one raw
        ``.bin`` file per array, rows below ``n`` only, uint32 words where
        the reference holds uint32.  A record either package writes loads
        in the other.

        Beyond the reference's record, which its loader ignores: every
        `GraphConfig` field (the reference writes eight), the start
        strategy, and the start point in use as ``auto_start`` (the
        reference's loader derives the medoid again from all rows, which
        can differ from the one a build took at its second batch)."""
        n = self.n
        host = lambda t: t.cpu().numpy()  # noqa: E731
        config = dataclasses.asdict(self.config)
        config["metric"] = self.config.metric.value
        meta = {
            "n": n, "dim": self.dim, "dtype": graph_state.dtype_name(self.dtype),
            "n_deleted": self.n_deleted,
            "free_slots": [int(i) for i in self.free_slots],
            "hbm_vectors_dropped": self._hbm_vectors_dropped,
            "config": config,
            "start_strategy": list(self._start_strategy),
        }
        st = self.state
        arrays = {"adjacency": host(st.adjacency[:n]), "degrees": host(st.degrees[:n]),
                  "valid": host(st.valid[:n])}
        if not self._hbm_vectors_dropped:
            # the norms are kept, not recomputed: "identical results after
            # a reload" is the contract
            arrays["vectors"] = graph_state.vectors_to_host(st.vectors[:n])
            arrays["sq_norms"] = host(st.sq_norms[:n])
        if self._cached_start is not None:
            arrays["cached_start"] = host(self._cached_start)
        elif not self._hbm_vectors_dropped and self.n_live > 0:
            arrays["auto_start"] = host(self._start())
        if self.packed is not None:
            p = self.packed
            meta["packed"] = {"r_pack": int(p.r_pack), "dp": int(p.dp)}
            arrays.update(packed_proj=host(p.proj), packed_pscale=host(p.pscale),
                          packed_pbias2=host(p.pbias2),
                          packed_self_codes=host(p.self_codes[:n]),
                          packed_self_aux=host(p.self_aux[:n]),
                          packed_rows=host(p.rows[: n * p.nwr]))
        if self.pq is not None:
            arrays.update(pq_pivots=host(self.pq.pivots), pq_codes=host(self.pq_codes[:n]))
        if self.sq is not None:
            meta["sq"] = {"n_bits": int(self.sq.n_bits)}
            arrays.update(sq_scale=host(self.sq.scale), sq_bias=host(self.sq.bias),
                          sq_codes=host(self.sq_codes[:n]), sq_bias2=host(self.sq_bias2),
                          sq_aux=host(self.sq_aux[:n]))
        if self.sph is not None:
            meta["spherical"] = {"n_bits": int(self.sph.n_bits)}
            arrays.update(sph_rotation=host(self.sph.rotation),
                          sph_words=host(self.sph_words[:n]).view(np.uint32),
                          sph_norms=host(self.sph_norms[:n]),
                          sph_cscale=host(self.sph_cscale[:n]))
        if self.mm is not None:
            meta["minmax"] = {"n_bits": int(self.mm.n_bits)}
            arrays.update(mm_codes=host(self.mm_codes[:n]), mm_lo=host(self.mm_lo[:n]),
                          mm_step=host(self.mm_step[:n]), mm_aux=host(self.mm_aux[:n]))
        if self.labels is not None:
            meta["labels"] = {"vocab": self.labels.vocab}
            arrays["labels_bits"] = host(self.labels.bits[:n]).view(np.uint32)
        save_record(path, kind="graph_index", meta=meta, arrays=arrays,
                    bfloat16=("vectors",) if self.dtype == torch.bfloat16 else ())

    @classmethod
    def load(cls, path: str, device=None, **kwargs) -> "GraphIndex":
        """Load a record written by `save` (of either package) onto
        ``device`` (the CUDA card by default).  Capacity is max(n, 1024),
        rounded up to the insert batch, so later inserts grow the tables
        as the reference's do; every `GraphConfig` field present is
        restored (the reference's loader reads eight).  kwargs go to
        `GraphIndex` (batch sizes, backedge cap); the vectors keep the
        record's dtype unless ``dtype`` says otherwise."""
        manifest, arrays = load_record(path)
        meta = manifest["meta"]
        kwargs.setdefault("dtype", meta.get("dtype", "float32"))
        names = {f.name for f in dataclasses.fields(GraphConfig)}
        c = {k: v for k, v in meta["config"].items() if k in names}
        c["metric"] = Metric(c["metric"])
        n = int(meta["n"])
        idx = cls(int(meta["dim"]), GraphConfig(**c), capacity=max(n, 1024),
                  device=device, **kwargs)
        idx.n = n
        idx.n_deleted = int(meta.get("n_deleted", 0))
        idx.free_slots = [int(i) for i in meta.get("free_slots", [])]
        if "start_strategy" in meta:
            strat, k, seed = meta["start_strategy"]
            idx._start_strategy = (strat, int(k), int(seed))
        dev = idx.device
        cap = idx.state.capacity
        host = lambda name: torch.from_numpy(np.ascontiguousarray(arrays[name]))  # noqa: E731

        def table(shape, dtype, name, fill=0):
            """A [cap, ...] device table: the record's rows below n, then
            ``fill``."""
            out = torch.full(shape, fill, dtype=dtype, device=dev)
            out[:n].copy_(host(name).view(dtype))
            return out

        st = idx.state
        st.valid[:n].copy_(host("valid"))
        st.adjacency[:n].copy_(host("adjacency"))
        st.degrees[:n].copy_(host("degrees"))
        if meta.get("hbm_vectors_dropped", False):
            idx._hbm_vectors_dropped = True
            idx.state = st._replace(vectors=torch.zeros((1, idx.dim), dtype=idx.dtype,
                                                        device=dev),
                                    sq_norms=torch.zeros((1,), device=dev))
        else:
            st.vectors[:n].copy_(graph_state.vectors_from_host(
                arrays["vectors"], meta.get("dtype", "float32")))
            if "sq_norms" in arrays:
                st.sq_norms[:n].copy_(host("sq_norms"))
            else:
                st.sq_norms[:n] = squared_norms(st.vectors[:n])
            st.vec_sum.copy_(torch.where(st.valid[:n, None], st.vectors[:n].float(),
                                         0.0).sum(0))
        if "cached_start" in arrays:
            idx._cached_start = host("cached_start").to(dev)
        elif "auto_start" in arrays:
            idx._auto_start = host("auto_start").to(dev)

        if "packed" in meta:
            rp, dp = int(meta["packed"]["r_pack"]), int(meta["packed"]["dp"])
            rows = packed_mod._empty_rows(cap + 1, rp, dp, device=dev)
            rows[: arrays["packed_rows"].shape[0]].copy_(host("packed_rows"))
            idx.packed = packed_mod.PackedState(
                proj=host("packed_proj").to(dev), pscale=host("packed_pscale").to(dev),
                pbias2=host("packed_pbias2").to(dev),
                self_codes=table((cap, dp), torch.int8, "packed_self_codes"),
                self_aux=table((cap,), torch.float32, "packed_self_aux"),
                rows=rows, r_pack=rp)
        if "pq_pivots" in arrays:
            idx.pq = PQ(pivots=host("pq_pivots").to(dev), dim=idx.dim)
            idx.pq_codes = table((cap, idx.pq.n_chunks), torch.uint8, "pq_codes")
        if "sq" in meta:
            idx.sq = ScalarQuantizer(scale=host("sq_scale").to(dev),
                                     bias=host("sq_bias").to(dev),
                                     n_bits=int(meta["sq"]["n_bits"]))
            idx.sq_codes = table((cap, idx.dim), torch.int8, "sq_codes")
            idx.sq_bias2 = host("sq_bias2").to(dev)
            idx.sq_aux = table((cap,), torch.float32, "sq_aux")
        if "spherical" in meta:
            idx.sph = SphericalQuantizer(rotation=host("sph_rotation").to(dev),
                                         n_bits=int(meta["spherical"]["n_bits"]))
            wd = arrays["sph_words"].shape[1]
            arrays["sph_words"] = arrays["sph_words"].view(np.int32)
            idx.sph_words = table((cap, wd), torch.int32, "sph_words")
            idx.sph_norms = table((cap,), torch.float32, "sph_norms")
            idx.sph_cscale = table((cap,), torch.float32, "sph_cscale")
        if "minmax" in meta:
            idx.mm = MinMaxQuantizer(n_bits=int(meta["minmax"]["n_bits"]))
            idx.mm_codes = table((cap, idx.dim), torch.int8, "mm_codes")
            idx.mm_lo = table((cap,), torch.float32, "mm_lo")
            idx.mm_step = table((cap,), torch.float32, "mm_step", fill=1.0)
            idx.mm_aux = table((cap,), torch.float32, "mm_aux")
        if "labels" in meta:
            arrays["labels_bits"] = arrays["labels_bits"].view(np.int32)
            nw = arrays["labels_bits"].shape[1]
            idx.labels = LabelSet(cap, meta["labels"]["vocab"], nw, device=dev)
            idx.labels.bits = table((cap, nw), torch.int32, "labels_bits")
        return idx
