"""Database-sharded index on one device (PyTorch port of
`diskann_tpu/parallel/sharded.py`).

- The id space is split into ``n_shards`` ranges of ``cap_per_shard``
  slots; every slot also carries an EXTERNAL id, so one logical vector may
  live in several shards (overlap routing, as `parallel/partition.py`
  assigns it) and results are deduplicated by external id at merge time.
- The reference puts each shard on its own device of a mesh and fans its
  work out with `shard_map`.  The port's target is one card, so the shards
  share it: the per-shard work is a loop over the shards, and the
  reference's `all_gather` is a concatenation before the merge.
- Layout: the reference's stacked one.  Each `GraphArrays` field is one
  ``[n_shards, cap, ...]`` tensor (``stacked``) and ``ext`` is ``[n_shards,
  cap]`` int32, as the reference's record holds them.  Shard ``s`` is the
  `GraphArrays` of views ``stacked.<field>[s]`` (`shard`), so the port's
  own per-index calls run on it unchanged and write the stacked tensors in
  place: `graph/build.insert_batch`, `graph/search.beam_search` and
  `beam_search_scored`, `graph/delete`'s mark, `patch_rows` and
  `drop_deleted_rows`, and `graph/packed`'s `alloc_packed` / `encode` /
  `refresh_rows` (a list of per-shard `PackedState`, never saved, as in
  the reference).
- Search runs each shard's walk, maps its ids to external ids, and merges
  the per-shard lists with one lexicographic (distance, id) sort that puts
  overlap copies side by side (`_merge_topk_dedup`).  Deletes find each
  shard's copies by a membership test of its ``ext`` column on the device
  (no host id map), repair the referencing rows, and hand the slots to a
  per-shard freelist derived from ``~valid`` below the high-water mark.
"""

from __future__ import annotations

import numpy as np
import torch

from diskann_tpu_torch.devices import default_device
from diskann_tpu_torch.graph import delete as delete_mod
from diskann_tpu_torch.graph import packed as packed_mod
from diskann_tpu_torch.graph import state as graph_state
from diskann_tpu_torch.graph.build import insert_batch
from diskann_tpu_torch.graph.config import GraphConfig
from diskann_tpu_torch.graph.scorers import full_precision_scorer, packed_scorer
from diskann_tpu_torch.graph.search import beam_search, beam_search_scored
from diskann_tpu_torch.graph.state import GraphArrays
from diskann_tpu_torch.ops.distance import Metric, distance_to_set, squared_norms
from diskann_tpu_torch.ops.topk import smallest_k, sort_lex, sort_with

# rows repaired or refreshed per call in a delete (the reference's chunk)
_DELETE_CHUNK = 4096
# fat rows rebuilt per call in attach_packed
_ATTACH_ROWS = 65536
# queries walked at once (each query's walk is independent)
_QUERY_ROWS = 8192


def _stacked_alloc(n_shards, cap, dim, r_slack, dtype, device) -> GraphArrays:
    one = graph_state.alloc(cap, dim, r_slack, dtype, device=device)
    return GraphArrays(*(a[None].repeat((n_shards,) + (1,) * a.dim()) for a in one))


def _merge_topk_dedup(all_d, all_i, k):
    """[S, B, L] per-shard sorted lists (EXTERNAL ids) -> global top-k with
    duplicate external ids removed.  Copies of one vector in different
    shards carry bitwise-equal distances (same formula, same bytes), so a
    (distance, id) sort lands them side by side, where one shifted compare
    marks the later ones."""
    s, b, l = all_d.shape
    md = all_d.permute(1, 0, 2).reshape(b, s * l)
    mi = all_i.permute(1, 0, 2).reshape(b, s * l)
    md, mi = sort_lex(md, mi)
    prev = torch.nn.functional.pad(mi[:, :-1], (1, 0), value=-2)
    dup = (mi == prev) & (mi >= 0)
    md = torch.where(dup, float("inf"), md)
    mi = torch.where(dup, -1, mi)
    md, mi = sort_with(md, mi)
    return md[:, :k], mi[:, :k]


class ShardedGraphIndex:
    """A Vamana index partitioned into ``n_shards`` shards on one device.

    Vectors are addressed by EXTERNAL id (assigned at insert, returned by
    `search`); one external id may be stored in several shards (overlap
    routing), and deletes remove every copy."""

    packed: list | None = None
    label_bits = None
    label_vocab = None
    _labels_per_ext = None
    _labels_stale = False

    def __init__(
        self,
        n_shards: int,
        dim: int,
        config: GraphConfig | None = None,
        *,
        cap_per_shard: int = 4096,
        dtype=torch.float32,
        device=None,
    ):
        """``dtype``: how the vectors are stored, as for `GraphIndex`;
        ``device``: where every shard lives (the CUDA card by default)."""
        self.n_shards = int(n_shards)
        self.config = config or GraphConfig()
        self.dim = dim
        self.cap_per_shard = cap_per_shard
        self.dtype = graph_state.vector_dtype(dtype)
        self.device = default_device(device)
        self.stacked = _stacked_alloc(self.n_shards, cap_per_shard, dim,
                                      self.config.max_degree_with_slack,
                                      self.dtype, self.device)
        # per-shard high-water marks, on the host (the reference keeps them
        # on the mesh; here every shard is on the host's one card)
        self.ns = np.zeros(self.n_shards, np.int64)
        self.starts = torch.full((self.n_shards, 1), -1, dtype=torch.int32,
                                 device=self.device)
        self.ext = torch.full((self.n_shards, cap_per_shard), -1, dtype=torch.int32,
                              device=self.device)
        self.next_ext = 0
        # no host-side external id -> slot map: a delete looks its ids up
        # on the device, in the `ext` columns
        self.n_deleted = 0
        # freed slots in all shards (each shard's freelist is derived from
        # ~valid below its high-water mark)
        self._free_total = 0

    def shard(self, s: int) -> GraphArrays:
        """Shard ``s``'s arrays: views into ``stacked``."""
        return GraphArrays(*(a[s] for a in self.stacked))

    # ------------------------------------------------------------------ grow
    def grow(self, new_cap_per_shard: int) -> None:
        """Grow every shard's capacity (pad all stacked arrays); an attached
        packed layout is rebuilt."""
        extra = new_cap_per_shard - self.cap_per_shard
        if extra <= 0:
            return
        st = self.stacked
        pad = torch.nn.functional.pad
        self.stacked = GraphArrays(
            vectors=pad(st.vectors, (0, 0, 0, extra)),
            sq_norms=pad(st.sq_norms, (0, extra)),
            adjacency=pad(st.adjacency, (0, 0, 0, extra), value=-1),
            degrees=pad(st.degrees, (0, extra)),
            valid=pad(st.valid, (0, extra)),
            vec_sum=st.vec_sum,
        )
        self.ext = pad(self.ext, (0, extra), value=-1)
        self.cap_per_shard = new_cap_per_shard
        self._labels_stale = True
        if self.packed is not None:
            self.attach_packed(dp=int(self.packed[0].dp))

    # ---------------------------------------------------------------- insert
    def insert(
        self,
        vectors: np.ndarray,
        assignments: np.ndarray | None = None,
        *,
        on_overflow: str = "grow",
    ) -> np.ndarray:
        """Insert vectors, routing each to one or more shards.

        assignments: None (round-robin), [m] single-shard, or [m, overlap]
        (each row's `overlap` nearest shards from `kmeans_partition`).
        Returns the external ids assigned to the rows.  on_overflow:
        "grow" at least doubles shard capacity; "error" raises — never
        silent loss.  Each shard commits its rows as one batch
        (`insert_batch`), freed slots first."""
        vectors = np.asarray(vectors, np.float32)
        m = vectors.shape[0]
        if assignments is None:
            assignments = (np.arange(m) + self.next_ext) % self.n_shards
        assignments = np.asarray(assignments)
        if assignments.ndim == 1:
            assignments = assignments[:, None]
        ext_ids = np.arange(self.next_ext, self.next_ext + m, dtype=np.int64)

        # dedup shard ids within each row, then group (shard, row) pairs by
        # shard with one stable argsort
        a = np.sort(assignments, axis=1)
        keep = a >= 0
        keep[:, 1:] &= a[:, 1:] != a[:, :-1]
        pair_s = a[keep].astype(np.int64)
        pair_j = np.broadcast_to(np.arange(m)[:, None], a.shape)[keep]
        order = np.argsort(pair_s, kind="stable")
        pair_s, pair_j = pair_s[order], pair_j[order]
        counts = np.bincount(pair_s, minlength=self.n_shards)

        need = int((self.ns + counts).max()) if len(pair_s) else 0
        if need > self.cap_per_shard:
            if on_overflow == "error":
                raise ValueError(
                    f"shard overflow: need {need} > cap {self.cap_per_shard}"
                )
            self.grow(max(need, self.cap_per_shard * 2))

        if len(pair_s):
            vecs = torch.from_numpy(vectors).to(self.device)
            rows = torch.from_numpy(pair_j).to(self.device)
            rext = torch.from_numpy(ext_ids[pair_j].astype(np.int32)).to(self.device)
            bounds = np.concatenate([[0], np.cumsum(counts)])
            for s in np.nonzero(counts)[0]:
                lo, hi = bounds[s], bounds[s + 1]
                self._insert_shard(int(s), vecs[rows[lo:hi]], rext[lo:hi])
        self.next_ext += m
        self._labels_stale = True
        return ext_ids

    def _insert_shard(self, s: int, vecs: torch.Tensor, rext: torch.Tensor) -> None:
        st = self.shard(s)
        n = int(self.ns[s])
        m = vecs.shape[0]
        free = torch.nonzero(~st.valid[:n]).squeeze(1)      # ascending
        take = min(free.shape[0], m)
        slots = torch.cat([free[:take],
                           torch.arange(n, n + m - take, device=self.device)])
        slots = slots.to(torch.int32)
        packed = self.packed[s] if self.packed is not None else None
        insert_batch(st, slots, vecs, torch.ones(m, dtype=torch.bool, device=self.device),
                     self.starts[s], self.config, packed)
        self.ext[s, slots.long()] = rext
        self.ns[s] = n + m - take
        self.starts[s] = graph_state.medoid(st, int(self.ns[s]))

    # ---------------------------------------------------------------- delete
    def delete(self, ext_ids) -> None:
        """Delete by external id: every shard finds its copies on the device
        (membership test of its `ext` column), marks them, repairs its
        referencing rows (prune repair, `patch_rows`), clears the deleted
        rows, refreshes an attached packed layout's dirty fat rows, and
        takes a new medoid start (the old one may be among the deleted).
        Freed slots are recycled by later inserts."""
        ext_ids = np.unique(np.asarray(ext_ids).ravel().astype(np.int32))
        if len(ext_ids) == 0:
            return
        dead = torch.from_numpy(ext_ids).to(self.device)
        for s in range(self.n_shards):
            st = self.shard(s)
            hit = torch.isin(self.ext[s], dead) & st.valid
            marked = delete_mod.mark_deleted(st, torch.nonzero(hit).squeeze(1))
            self._free_total += int(marked.shape[0])
            self.ext[s].masked_fill_(hit, -1)
            aff = delete_mod.rows_referencing_deleted(st)
            rows = torch.nonzero(aff).squeeze(1)
            for off in range(0, rows.shape[0], _DELETE_CHUNK):
                delete_mod.patch_rows(st, rows[off:off + _DELETE_CHUNK], self.config)
            delete_mod.drop_deleted_rows(st)
            if self.packed is not None:
                dirty = torch.nonzero(aff | hit).squeeze(1)
                for off in range(0, dirty.shape[0], _DELETE_CHUNK):
                    packed_mod.refresh_rows(self.packed[s], st.adjacency,
                                            dirty[off:off + _DELETE_CHUNK])
            self.starts[s] = graph_state.medoid(st, int(self.ns[s]))
        self.n_deleted += len(ext_ids)

    # ---------------------------------------------------------------- packed
    def attach_packed(self, *, dp: int = 64, train_sample=None) -> None:
        """Build each shard's packed fat-row layout (enables mode="packed"
        search).  The projection is trained once, on ``train_sample`` or
        on up to 256 live rows drawn from every shard's front."""
        if train_sample is None:
            per = max(1, int(np.ceil(256 / max(self.n_shards, 1))))
            parts = [self.stacked.vectors[s, : min(int(n_s), per)].float().cpu().numpy()
                     for s, n_s in enumerate(self.ns) if n_s > 0]
            train_sample = (np.concatenate(parts, axis=0) if parts
                            else np.zeros((1, self.dim), np.float32))
        proj, pscale, pbias2 = packed_mod.train_packed(
            np.asarray(train_sample, np.float32), min(dp, self.dim),
            self.config.metric, device=self.device,
        )
        self.packed = None      # free the old tables first
        cap = self.cap_per_shard
        ids = torch.arange(cap, device=self.device)
        out = []
        for s in range(self.n_shards):
            st = self.shard(s)
            p = packed_mod.alloc_packed(proj, pscale, pbias2, cap,
                                        self.config.max_degree_with_slack)
            codes, aux = packed_mod.encode(p, st.vectors, self.config.metric)
            packed_mod.set_self_codes(p, ids, codes, aux)
            for off in range(0, cap, _ATTACH_ROWS):
                packed_mod.refresh_rows(p, st.adjacency, ids[off:off + _ATTACH_ROWS])
            out.append(p)
        self.packed = out

    # ---------------------------------------------------------------- labels
    def attach_labels(self, labels_per_ext: list) -> None:
        """Assign labels keyed by EXTERNAL id (``labels_per_ext[e]``: the
        label strings of external id e).  Each shard holds the bitset rows
        of its own slots, so filtered search runs shard-local.  External
        ids beyond the list (or added later) carry no labels and never
        match a predicate."""
        self._labels_per_ext = list(labels_per_ext)
        self._labels_stale = True
        self._rebuild_label_bits()

    def _rebuild_label_bits(self) -> None:
        """(Re)scatter the label rows to each shard's CURRENT slots: insert
        and grow move and add slots."""
        from diskann_tpu_torch.filters import LabelSet

        lists = self._labels_per_ext
        n_ext = max(len(lists), self.next_ext, 1)
        if len(lists) < n_ext:
            lists = lists + [[] for _ in range(n_ext - len(lists))]
        ls = LabelSet.from_lists(lists, capacity=n_ext, device=self.device)
        self.label_vocab = ls.vocab
        safe = self.ext.long().clamp(0, ls.bits.shape[0] - 1)
        self.label_bits = torch.where((self.ext >= 0)[:, :, None], ls.bits[safe], 0)
        self._labels_stale = False

    # ---------------------------------------------------------------- search
    def _queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries, dtype=torch.float32, device=self.device)

    def _merged(self, q, k, walk):
        """Run ``walk(s, shard, queries) -> (dists [B, L], local ids [B, L]
        with -1 where dropped, cmps [B])`` on every shard, map the ids to
        external ids and merge.  Returns host (dists, ids, cmps summed over
        the shards)."""
        outs = []
        for off in range(0, q.shape[0], _QUERY_ROWS):
            qb = q[off:off + _QUERY_ROWS]
            all_d, all_i, cmps = [], [], 0
            for s in range(self.n_shards):
                st = self.shard(s)
                d, ids, c = walk(s, st, qb)
                safe = ids.long().clamp(0, self.cap_per_shard - 1)
                ok = (ids >= 0) & st.valid[safe]
                all_d.append(torch.where(ok, d, float("inf")))
                all_i.append(torch.where(ok, self.ext[s][safe], -1))
                cmps = cmps + c
            md, mi = _merge_topk_dedup(torch.stack(all_d), torch.stack(all_i), k)
            outs.append((md, mi, cmps))
        return tuple(torch.cat(t).cpu().numpy() for t in zip(*outs))

    def search(self, queries, k: int, *, l_search: int | None = None,
               mode: str = "full"):
        """Returns (dists [B,k], EXTERNAL ids [B,k], cmps [B] summed over
        the shards).  mode="packed" walks each shard's packed layout
        (attaching one first if needed) and reranks its list at full
        precision before the merge."""
        q = self._queries(queries)
        l = l_search or max(k, self.config.l_build)
        cfg = self.config
        if mode == "packed":
            if self.packed is None:
                self.attach_packed()

            def walk(s, st, qb):
                p = self.packed[s]
                sdef, sdata = packed_scorer(p, cfg.metric)
                res = beam_search_scored(
                    sdef, sdata, st.adjacency, self.starts[s], qb, l_search=l,
                    beam_width=cfg.beam_width, max_hops=cfg.max_hops,
                    dedup="merge", expand_r=p.r_pack,
                )
                # local full-precision rerank before the merge
                safe = res.ids.long().clamp(0, self.cap_per_shard - 1)
                dd = distance_to_set(qb, st.vectors[safe], cfg.metric,
                                     x_sq_norms=st.sq_norms[safe])
                dd = torch.where((res.ids >= 0) & st.valid[safe], dd, float("inf"))
                dd, ii = sort_with(dd, res.ids)
                return dd[:, :k], ii[:, :k], res.cmps
        elif mode == "full":
            def walk(s, st, qb):
                res = beam_search(st.vectors, st.sq_norms, st.adjacency, self.starts[s],
                                  qb, metric=cfg.metric, l_search=l,
                                  beam_width=cfg.beam_width, max_hops=cfg.max_hops)
                return res.dists, res.ids, res.cmps
        else:
            raise ValueError(f"unknown search mode {mode!r}")
        return self._merged(q, k, walk)

    def search_filtered(self, queries, predicate, k: int = 10, *,
                        l_search: int | None = None,
                        filter_beta: float | None = None):
        """Label-filtered k-NN over every shard (the inline beta filter;
        the matched lists merge with external-id dedup).  Returns (true
        dists [B,k], EXTERNAL ids [B,k], cmps [B] summed over the shards)."""
        from diskann_tpu_torch.filters import compile_accept, parse_predicate

        if self.label_bits is None:
            raise ValueError("attach_labels first")
        if self._labels_stale:
            self._rebuild_label_bits()
        if isinstance(predicate, str):
            predicate = parse_predicate(predicate)
        accept_fn = compile_accept(predicate, self.label_vocab, self.cap_per_shard)
        l = l_search or max(k, self.config.l_build)
        cfg = self.config
        beta = filter_beta if filter_beta is not None else 0.5

        def walk(s, st, qb):
            sdef, sdata = full_precision_scorer(st.vectors, st.sq_norms, cfg.metric)
            res = beam_search_scored(
                sdef, sdata, st.adjacency, self.starts[s], qb, l_search=l,
                beam_width=cfg.beam_width, max_hops=cfg.max_hops,
                history_capacity=cfg.history_capacity(l), accept_fn=accept_fn,
                accept_data=self.label_bits[s], filter_beta=beta,
                filter_mode="inline",
            )
            return res.match_d, res.match_i, res.cmps

        return self._merged(self._queries(queries), k, walk)

    def search_range(self, queries, radius: float, *,
                     l_init: int | None = None, l_max: int = 1024):
        """All EXTERNAL ids within `radius` of each query (L-doubling rounds
        over every shard, overlap copies deduplicated at the merge)."""
        from diskann_tpu_torch.graph.modes import range_search

        return range_search(self, queries, radius, l_init=l_init, l_max=l_max)

    # -------------------------------------------------------------- save/load
    def save(self, path: str) -> None:
        """Persist all shards and the external ids in the reference's record
        (kind "sharded_graph_index": the stacked arrays, the eight config
        fields it writes); either package loads it.  Packed layouts and
        labels are not saved, as in the reference."""
        from diskann_tpu_torch.io_.record import save_record

        cfg = self.config
        st = self.stacked
        host = lambda t: t.cpu().numpy()  # noqa: E731
        save_record(
            path,
            kind="sharded_graph_index",
            meta={
                "n_shards": self.n_shards,
                "dim": self.dim,
                "cap_per_shard": self.cap_per_shard,
                "next_ext": self.next_ext,
                "n_deleted": self.n_deleted,
                "free_total": self._free_total,
                "config": {
                    "max_degree": cfg.max_degree,
                    "l_build": cfg.l_build,
                    "alpha": cfg.alpha,
                    "graph_slack_factor": cfg.graph_slack_factor,
                    "max_occlusion_size": cfg.max_occlusion_size,
                    "saturate_after_prune": cfg.saturate_after_prune,
                    "metric": cfg.metric.value,
                    "beam_width": cfg.beam_width,
                },
            },
            arrays={
                "vectors": graph_state.vectors_to_host(st.vectors),
                "sq_norms": host(st.sq_norms),
                "adjacency": host(st.adjacency),
                "degrees": host(st.degrees),
                "valid": host(st.valid),
                "vec_sum": host(st.vec_sum),
                "ext": host(self.ext),
                "ns": self.ns.astype(np.int32),
                "starts": host(self.starts),
            },
            bfloat16=("vectors",) if self.dtype == torch.bfloat16 else (),
        )

    @classmethod
    def load(cls, path: str, *, device=None) -> "ShardedGraphIndex":
        """Load a record written by `save` (of either package) onto
        ``device`` (the CUDA card by default), with the record's shard
        count and vector dtype."""
        from diskann_tpu_torch.io_.record import load_record

        manifest, arrays = load_record(path)
        meta = manifest["meta"]
        c = meta["config"]
        cfg = GraphConfig(
            max_degree=c["max_degree"],
            l_build=c["l_build"],
            alpha=c["alpha"],
            graph_slack_factor=c["graph_slack_factor"],
            max_occlusion_size=c["max_occlusion_size"],
            saturate_after_prune=c["saturate_after_prune"],
            metric=Metric(c["metric"]),
            beam_width=c.get("beam_width", 1),
        )
        dtype = manifest["artifacts"]["vectors"]["dtype"]
        idx = cls(meta["n_shards"], meta["dim"], cfg, cap_per_shard=1, dtype=dtype,
                  device=device)
        dev = idx.device
        put = lambda name: torch.from_numpy(np.ascontiguousarray(arrays[name])).to(dev)  # noqa: E731
        idx.stacked = GraphArrays(
            vectors=graph_state.vectors_from_host(arrays["vectors"], dtype).to(dev),
            sq_norms=put("sq_norms"),
            adjacency=put("adjacency"),
            degrees=put("degrees"),
            valid=put("valid"),
            vec_sum=put("vec_sum"),
        )
        idx.cap_per_shard = int(meta["cap_per_shard"])
        idx.ext = put("ext")
        idx.ns = np.asarray(arrays["ns"], np.int64).copy()
        idx.starts = put("starts")
        idx.next_ext = int(meta["next_ext"])
        idx.n_deleted = int(meta.get("n_deleted", 0))
        idx._free_total = int(meta.get("free_total", 0))
        return idx


def sharded_flat_search(n_shards: int, vectors, queries, k: int,
                        metric: Metric = Metric.L2, *, device=None):
    """Exact top-k over a database cut into ``n_shards`` blocks of rows:
    each block's distances and local top-k, then a merge of the blocks'
    lists.  Equal distances keep ascending id order (each block's top-k
    does, the blocks are in id order and the merge sort is stable), as
    `FlatIndex` does.  ``vectors`` and ``queries``: numpy arrays or
    tensors; the scan runs on ``device`` (default: the vectors' device if
    a tensor, else the CUDA card).  Returns (dists [B, k'], ids [B, k'])
    tensors, k' = min(k, the rows the blocks offer)."""
    if device is None and isinstance(vectors, torch.Tensor):
        device = vectors.device
    device = default_device(device)
    x = torch.as_tensor(vectors, device=device)
    q = torch.as_tensor(queries, dtype=torch.float32, device=device)
    n = x.shape[0]
    local_n = -(-n // n_shards)
    all_d, all_i = [], []
    for s in range(n_shards):
        v = x[s * local_n:(s + 1) * local_n]
        if v.shape[0] == 0:
            continue
        dist = distance_to_set(q, v, metric, x_sq_norms=squared_norms(v))
        kk = min(k, local_n)
        dd, cols = smallest_k(dist, min(kk, v.shape[0]))
        all_d.append(dd)
        all_i.append(cols.to(torch.int32) + s * local_n)
    md, mi = sort_with(torch.cat(all_d, 1), torch.cat(all_i, 1))
    out = min(k, md.shape[1])
    return md[:, :out], mi[:, :out]
