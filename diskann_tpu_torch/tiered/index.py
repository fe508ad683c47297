"""Tiered index: compact codes and the graph on the card, full vectors in
host RAM (PyTorch port of `diskann_tpu/tiered/index.py`).

Search flow, per query batch:

1. the walk on the card over the quantized codes (the packed fat rows
   through the `fatrow_expand` kernel, or the SQ / PQ codes), from router
   entry points when a router is attached;
2. the top candidate ids come to the host, and their full-precision rows
   are gathered from host RAM (`HostVectorStore`: the native mmap reader's
   thread pool, or numpy);
3. the rows go up through a pinned host buffer and are reranked exactly
   on the card.

Batches are pipelined as in the reference: batch i's gather is submitted
to the reader's threads, batch i+1's walk runs, and only then does the
host wait for batch i's rows and rerank them.  ``io_limit`` caps the rows
staged per query (the disk tier's IO budget).  Each step runs in a
`torch.profiler` range: ``tiered.traverse``, ``tiered.stage_wait``,
``tiered.upload`` and ``tiered.rerank``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from diskann_tpu_torch.filters import compile_accept, parse_predicate
from diskann_tpu_torch.graph.config import GraphConfig
from diskann_tpu_torch.graph.index import GraphIndex, SearchStats, _round_queries
from diskann_tpu_torch.graph.scorers import smallest_ids
from diskann_tpu_torch.graph.search import beam_search_scored
from diskann_tpu_torch.io_.fbin import read_fbin, write_fbin
from diskann_tpu_torch.native import NativeVectorFile
from diskann_tpu_torch.ops.distance import Metric, distance_to_set, squared_norms
from diskann_tpu_torch.ops.topk import sort_with
from diskann_tpu_torch.trace import span


class HostVectorStore:
    """Full-precision vectors in host RAM: an array (possibly a memmap), or
    an `.fbin` file read by the native reader (`diskann_tpu_torch.native`:
    mmap, a threaded batched gather, an LRU row cache) when it builds."""

    def __init__(self, vectors: np.ndarray):
        self.vectors = vectors
        self.n, self.dim = vectors.shape
        self._native = None
        self.source_path: str | None = None

    @classmethod
    def from_fbin(cls, path: str, *, cache_rows: int = 0, uring: bool = False):
        """A store over an `.fbin` file: the native reader (``uring=True``
        asks for io_uring batched reads, right for cold reads from an SSD;
        mmap wins when the file is in the page cache), else a numpy memmap
        on a host without a compiler."""
        try:
            nf = NativeVectorFile(path, 4, cache_rows=cache_rows, uring=uring)
        except (RuntimeError, OSError):
            self = cls(read_fbin(path, mmap=True))
        else:
            self = cls.__new__(cls)
            self.vectors = None
            self.n, self.dim = nf.n, nf.dim
            self._native = nf
        self.source_path = path
        return self

    @property
    def is_native(self) -> bool:
        """Whether gathers go through the native reader."""
        return self._native is not None

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        """Batched row gather: [..., dim] float32 rows of ``ids`` (clamped
        to the stored rows)."""
        ids = np.asarray(ids)
        if self._native is not None:
            return self._native.gather(ids.reshape(-1)).reshape(ids.shape + (self.dim,))
        safe = np.clip(ids, 0, self.n - 1)
        return np.ascontiguousarray(self.vectors[safe], dtype=np.float32)

    def fetch_async(self, ids: np.ndarray):
        """Submit a gather to the native reader's threads; pair with
        `fetch_wait`.  Without the native reader the gather runs now."""
        ids = np.asarray(ids)
        if self._native is not None:
            return ("native", ids.shape, self._native.gather_async(ids.reshape(-1)))
        return ("sync", ids.shape, self.fetch(ids))

    def fetch_wait(self, handle) -> np.ndarray:
        kind, shape, payload = handle
        if kind == "native":
            return self._native.wait(payload).reshape(shape + (self.dim,))
        return payload


# staged-row dtypes of the upload (``row_wire``)
_WIRE_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16}


def _host_queries(queries) -> np.ndarray:
    """[B, d] float32 numpy queries from numpy or a tensor on any device."""
    if isinstance(queries, torch.Tensor):
        queries = queries.detach().cpu().numpy()
    q = np.asarray(queries, np.float32)
    return q[None] if q.ndim == 1 else q


class TieredIndex:
    """A DiskANN-style two-tier index for collections whose full vectors do
    not fit on the card: ``graph`` (a `GraphIndex` whose vectors were
    dropped, `GraphIndex.drop_vectors`) walks its codes on the card, and
    ``store`` serves the full rows of the rerank."""

    def __init__(self, graph: GraphIndex, store, *, io_limit: int | None = None):
        self.graph = graph
        self.store = store
        self.io_limit = io_limit
        self.io_stats = {"rows_staged": 0, "stage_s": 0.0}
        self._router_ids: torch.Tensor | None = None
        self._router_table_cache: tuple | None = None
        self._pinned: torch.Tensor | None = None

    @property
    def config(self) -> GraphConfig:
        return self.graph.config

    def search_range(self, queries, radius: float, *, l_init: int | None = None,
                     l_max: int = 1024):
        """All ids within ``radius`` of each query: L-doubling rounds, each
        round's candidates reranked exactly from host rows, so membership
        in the radius is exact (`graph/modes.range_search`, restart
        route)."""
        from diskann_tpu_torch.graph.modes import range_search

        return range_search(self, queries, radius, l_init=l_init, l_max=l_max)

    @classmethod
    def build_from_host(cls, vectors: np.ndarray, config: GraphConfig | None = None, *,
                        dp: int = 64, insert_batch_size: int = 4096, device=None,
                        **kw) -> "TieredIndex":
        """Build the graph on ``device`` (the CUDA card by default), attach
        the packed layout at ``dp``, then pin the start point and drop the
        full vectors from the device: they stay in a host store.  kw go to
        `GraphIndex.build`."""
        vectors = np.asarray(vectors, np.float32)
        graph = GraphIndex.build(vectors, config, insert_batch_size=insert_batch_size,
                                 device=device, **kw)
        graph.attach_packed(dp=dp)
        graph.drop_vectors()
        return cls(graph, HostVectorStore(vectors))

    def _traversal_scorer(self, mode: str | None):
        """(mode, sdef, sdata, expand_r, dedup) of the walk on the card.
        None (or "full": the full rows live on the host) picks packed when
        attached, then sq, then pq."""
        g = self.graph
        if mode is None or mode == "full":
            mode = "packed" if g.packed is not None else ("sq" if g.sq is not None else "pq")
        sdef, sdata, expand_r = g._scorer_for_mode(mode)
        return mode, sdef, sdata, expand_r, "merge" if mode == "packed" else "list"

    # ------------------------------------------------------- router starts
    def attach_router(self, size: int = 65536, seed: int = 0xD15C) -> None:
        """Sample ``size`` live rows (``seed``) as per-query entry points:
        one product of the query batch against their codes picks each
        query's nearest, instead of one start point for all."""
        g = self.graph
        live = np.nonzero(g.state.valid[: g.n].cpu().numpy())[0]
        rng = np.random.default_rng(seed)
        sel = np.sort(rng.choice(live, size=min(size, len(live)), replace=False))
        self._router_ids = torch.as_tensor(sel.astype(np.int32), device=g.device)
        self._router_table_cache = None

    def _router_table(self, mode: str) -> tuple:
        """(kind, rows, aux) of the router for ``mode``, gathered once:
        int8 codes and their norms (sq, packed), or the PQ-decoded float32
        rows and their squared norms."""
        g = self.graph
        c = self._router_table_cache
        if c is not None and c[0] is self._router_ids and c[1] == mode:
            return c[2]
        rid = self._router_ids.long()
        if mode == "sq":
            tab = ("i8", g.sq_codes[rid], g.sq_aux[rid])
        elif mode == "packed":
            tab = ("i8", g.packed.self_codes[rid], g.packed.self_aux[rid])
        else:
            rv = g.pq.decode(g.pq_codes[rid])[:, : g.dim]
            tab = ("f32", rv, (rv * rv).sum(1))
        self._router_table_cache = (self._router_ids, mode, tab)
        return tab

    def _entry_points(self, q, mode, sdef, sdata, n_start: int) -> torch.Tensor:
        """[B, n_start] router entry points, or the graph's start point.
        The int8 router dot runs in float32, exact with TF32 off."""
        g = self.graph
        if n_start <= 0:
            return g._start()
        kind, rows, aux = self._router_table(mode)
        metric = g.config.metric
        if kind == "i8":
            qi, qscale, qsq = sdef.prep(sdata, q)
            dots = (qi.float() @ rows.float().T) * qscale[:, None]
            d = -dots if metric == Metric.InnerProduct else qsq[:, None] + aux[None, :] - 2.0 * dots
        else:
            d = distance_to_set(q, rows, metric, x_sq_norms=aux,
                                q_sq_norms=squared_norms(q) if metric.needs_norms else None)
        return smallest_ids(d, self._router_ids, n_start)

    # -------------------------------------------------------------- search
    def search(self, queries, k: int = 10, *, l_search: int | None = None,
               beam_width: int = 4, rerank_l: int | None = None, mode: str | None = None,
               max_hops: int | None = None, router_starts: int | None = None,
               query_dtype=None, row_wire=np.float32, batch_size: int | None = None):
        """Walk on the codes, then an exact rerank of host-staged rows:
        `search_batched` with router entry points when a router is
        attached, in batches of ``batch_size`` (default: the graph's search
        batch size)."""
        if router_starts is None:
            router_starts = 4 if self._router_ids is not None else 0
        bs = batch_size or self.graph.search_batch_size or 4096
        return self.search_batched(
            queries, k, batch_size=bs, l_search=l_search, beam_width=beam_width,
            rerank_l=rerank_l, mode=mode, max_hops=max_hops,
            router_starts=router_starts, query_dtype=query_dtype, row_wire=row_wire)

    def search_batched(self, queries, k: int = 10, *, batch_size: int = 4096,
                       l_search: int | None = None, beam_width: int = 4,
                       rerank_l: int | None = None, mode: str | None = None,
                       max_hops: int | None = None, router_starts: int = 0,
                       query_dtype=None, row_wire=np.float32):
        """Pipelined tiered search.  Returns (dists [B, k], ids [B, k],
        stats) as numpy arrays.

        Per batch: ``router_starts`` entry points from the router (0: the
        start point), the walk over the mode's codes (None: packed, then
        sq, then pq), then the top ``min(io_limit, rerank_l, L)``
        candidates staged from the host and reranked exactly.  query_dtype
        rounds the walk's queries (np.float16); row_wire=np.float16 rounds
        the staged rows for the upload."""
        g = self.graph
        queries = _host_queries(queries)
        l = l_search or max(k, g.config.l_build)
        budget = min(self.io_limit or l, rerank_l or l, l)
        mode, sdef, sdata, expand_r, dedup = self._traversal_scorer(mode)
        mh = max_hops or g.config.max_hops
        n_start = router_starts if self._router_ids is not None else 0
        hist = g.config.history_capacity(l)

        def traverse(q):
            st = self._entry_points(q, mode, sdef, sdata, n_start)
            res = beam_search_scored(sdef, sdata, g.state.adjacency, st, q, l_search=l,
                                     beam_width=beam_width, max_hops=mh,
                                     history_capacity=hist, dedup=dedup,
                                     expand_r=expand_r)
            return res.ids[:, :budget], res.cmps, res.hops

        return self._pipeline(queries, k, batch_size, query_dtype, row_wire, traverse)

    def search_filtered(self, queries, predicate, k: int = 10, *,
                        l_search: int | None = None, beam_width: int = 4,
                        filter_beta: float | None = None, method: str = "inline",
                        max_hops: int | None = None, router_starts: int | None = None,
                        query_dtype=None, row_wire=np.float32,
                        batch_size: int | None = None):
        """Label-filtered tiered search: the walk over the codes with the
        inline beta filter (default beta 0.5) collecting the matched list
        at quantized distances, then the staged matched rows reranked
        exactly (the reference's RerankAndFilter).  Needs labels attached
        on the graph; same pipeline as `search_batched`."""
        g = self.graph
        if g.labels is None:
            raise ValueError("attach labels on the graph first")
        if isinstance(predicate, str):
            predicate = parse_predicate(predicate)
        accept_fn = compile_accept(predicate, g.labels.vocab, g.state.capacity)
        queries = _host_queries(queries)
        l = l_search or max(k, g.config.l_build)
        budget = min(self.io_limit or l, l)
        mh = max_hops or g.config.max_hops
        if router_starts is None:
            router_starts = 4 if self._router_ids is not None else 0
        n_start = router_starts if self._router_ids is not None else 0
        beta = filter_beta if filter_beta is not None else 0.5
        mode, sdef, sdata, expand_r, _ = self._traversal_scorer(None)
        hist = g.config.history_capacity(l)

        def traverse(q):
            st = self._entry_points(q, mode, sdef, sdata, n_start)
            res = beam_search_scored(sdef, sdata, g.state.adjacency, st, q, l_search=l,
                                     beam_width=beam_width, max_hops=mh,
                                     history_capacity=hist, dedup="list",
                                     expand_r=expand_r, accept_fn=accept_fn,
                                     accept_data=g.labels.bits, filter_beta=beta,
                                     filter_mode=method)
            return res.match_i[:, :budget], res.cmps, res.hops

        bs = batch_size or g.search_batch_size or 4096
        return self._pipeline(queries, k, bs, query_dtype, row_wire, traverse,
                              span_name="tiered.traverse_filtered")

    def _pipeline(self, queries: np.ndarray, k: int, batch_size: int, query_dtype,
                  row_wire, traverse, span_name: str = "tiered.traverse"):
        """Run ``traverse`` (device queries -> staged ids [b, budget],
        cmps, hops) over the query batches, with batch i's host gather in
        flight while batch i+1 walks; then wait, upload, rerank.  Each walk
        is a trace span ``span_name``, each gather wait a
        ``tiered.stage_wait`` span, each upload ``tiered.upload`` and each
        rerank ``tiered.rerank`` (`trace.py`; profiler ranges too while a
        profiler runs)."""
        g = self.graph
        dev = g.device
        b = queries.shape[0]
        out_d = np.full((b, k), np.inf, np.float32)
        out_i = np.full((b, k), -1, np.int32)
        cmps = np.zeros((b,), np.int32)
        hops = np.zeros((b,), np.int32)
        pending = None
        for off in list(range(0, b, batch_size)) + [None]:
            nxt = None
            if off is not None:
                qf = torch.from_numpy(queries[off:off + batch_size]).to(dev)
                with span(span_name, offset=off, rows=qf.shape[0]):
                    ids, pc, ph = traverse(_round_queries(qf, query_dtype))
                    # one copy to the host, which waits for the walk
                    packed = torch.cat([ids, pc[:, None].int(), ph[:, None].int()], 1)
                    arr = packed.cpu().numpy()
                stage = arr[:, : ids.shape[1]]
                t0 = time.time()
                handle = self.store.fetch_async(np.maximum(stage, 0))
                self.io_stats["rows_staged"] += int(stage.size)
                self.io_stats["stage_s"] += time.time() - t0
                nxt = (off, qf, ids, handle, arr[:, -2], arr[:, -1])
            if pending is not None:
                poff, qf, ids, handle, pc, ph = pending
                with span("tiered.stage_wait", offset=poff):
                    rows = self.store.fetch_wait(handle)
                with span("tiered.upload", offset=poff):
                    rows = self._upload(rows, row_wire)
                with span("tiered.rerank", offset=poff):
                    d, i = _tiered_rerank(qf, rows, ids, g.state.valid, g.config.metric, k)
                    m, kk = i.shape
                    out_d[poff:poff + m, :kk] = d.cpu().numpy()
                    out_i[poff:poff + m, :kk] = i.cpu().numpy()
                cmps[poff:poff + m] = pc
                hops[poff:poff + m] = ph
            pending = nxt
        return out_d, out_i, SearchStats(cmps=cmps, hops=hops,
                                         result_count=(out_i >= 0).sum(axis=1))

    def _upload(self, rows: np.ndarray, row_wire) -> torch.Tensor:
        """Staged rows onto the card as ``row_wire`` (rounded on the host,
        as the reference does), through a pinned buffer and a non-blocking
        copy.  The buffer is written again only after the previous batch's
        results came back to the host, which waited for its copy."""
        dev = self.graph.device
        wire = np.dtype(row_wire)
        if dev.type != "cuda":
            return torch.from_numpy(rows.astype(wire, copy=False)).to(dev)
        tdt = _WIRE_DTYPES[wire]
        p = self._pinned
        if p is None or p.dtype != tdt or p.numel() < rows.size:
            p = self._pinned = torch.empty(rows.size, dtype=tdt, pin_memory=True)
        buf = p[: rows.size].view(rows.shape)
        np.copyto(buf.numpy(), rows, casting="same_kind")
        return buf.to(dev, non_blocking=True)

    # ----------------------------------------------------------- save/load
    def save(self, path: str, *, copy_vectors: bool | None = None) -> None:
        """Persist the tier: the graph and its codes as a `GraphIndex`
        record under ``graph/``, and ``tiered.json`` with ``io_limit`` and
        the store: its source file (``source_path``), or, for an in-RAM
        store (or ``copy_vectors=True``), the vectors written to
        ``vectors.fbin`` inside the record."""
        os.makedirs(path, exist_ok=True)
        self.graph.save(os.path.join(path, "graph"))
        store_meta = {"n": self.store.n, "dim": self.store.dim}
        src = getattr(self.store, "source_path", None)
        in_ram = getattr(self.store, "vectors", None)
        if copy_vectors is None:
            copy_vectors = src is None and in_ram is not None
        if copy_vectors:
            vecs = (np.asarray(in_ram, np.float32) if in_ram is not None
                    else self.store.fetch(np.arange(self.store.n)))
            write_fbin(os.path.join(path, "vectors.fbin"), vecs)
            store_meta["file"] = "vectors.fbin"
        else:
            store_meta["source_path"] = src
        with open(os.path.join(path, "tiered.json"), "w") as f:
            json.dump({"format_version": 1, "io_limit": self.io_limit,
                       "store": store_meta}, f, indent=2)

    @classmethod
    def load(cls, path: str, device=None) -> "TieredIndex":
        """Load a tier `save` wrote (either package's), the graph onto
        ``device`` (the CUDA card by default), the store from its file."""
        with open(os.path.join(path, "tiered.json")) as f:
            meta = json.load(f)
        graph = GraphIndex.load(os.path.join(path, "graph"), device=device)
        sm = meta["store"]
        if "file" in sm:
            store = HostVectorStore.from_fbin(os.path.join(path, sm["file"]))
        elif sm.get("source_path"):
            store = HostVectorStore.from_fbin(sm["source_path"])
        else:
            raise ValueError("tiered record has no vector source")
        return cls(graph, store, io_limit=meta.get("io_limit"))


def _tiered_rerank(queries, rows, ids, valid, metric: Metric, k: int):
    """Exact distances from each query to its staged rows ([B, C, d], any
    float dtype), deleted and -1 ids to (inf, -1), one stable sort, top k."""
    rows = rows.float()
    cap = valid.shape[0]
    ok = (ids >= 0) & valid[ids.long().clamp(0, cap - 1)]
    qsq = squared_norms(queries) if metric.needs_norms else None
    d = distance_to_set(queries, rows, metric, q_sq_norms=qsq)
    d, iid = sort_with(torch.where(ok, d, float("inf")), torch.where(ok, ids, -1))
    return d[:, :k], iid[:, :k]
