"""Database-sharded index over one or several devices (PyTorch port of
`diskann_tpu/parallel/sharded.py`).

- The id space is split into ``n_shards`` ranges of ``cap_per_shard``
  slots; every slot also carries an EXTERNAL id, so one logical vector may
  live in several shards (overlap routing, as `parallel/partition.py`
  assigns it) and results are deduplicated by external id at merge time.
- Placement, the counterpart of the reference's mesh: ``shards`` is an
  int (every shard on ``device``) or a sequence of devices, one per shard
  (shard ``s`` on ``shards[s]``; a card may hold several shards).
- Layout: per shard.  The reference stacks each `GraphArrays` field into
  one ``[n_shards, cap, ...]`` array that its mesh splits across devices;
  a torch tensor lives on one device, so here each shard owns its own
  `GraphArrays` (``arrays[s]``), ``ext[s]`` ([cap] int32 external ids),
  ``starts[s]`` ([1] int32), ``label_bits[s]`` and ``packed[s]``, all on
  ``devices[s]``; the high-water marks ``ns`` live on the host.  The one
  layout serves both placements, and the record stacks the shards on the
  host at save, so it stays the reference's.  The port's own per-index
  calls run on a shard unchanged (`shard`): the stepping forms of
  `graph/build.insert_batch`, `graph/search.beam_search` and
  `beam_search_scored` and `graph/delete.patch_rows`, `graph/delete`'s
  mark and `drop_deleted_rows`, and `graph/packed`'s `alloc_packed` /
  `encode` / `refresh_rows`.
- Fan-out, the counterpart of `shard_map` (`_fan_out`): one host thread
  drives every shard in lockstep.  A shard's work is a stepping generator
  (`graph/steps.py`: the hop loop, the occlusion scan and the insert and
  repair that compose them yield each "go on?" flag instead of reading
  it); each round advances every shard to its next flag in shard order,
  which queues that step on the shard's card, then copies the flags to
  the host behind one event per card and sends each its answer.  So every
  card runs its step while the host queues the others', and the host
  waits once a round, on the slowest card.  This replaced one host
  worker thread per card, whose threads handed Python's interpreter lock
  back and forth on every op: each card sat idle ~93% of an insert call
  (traced on four H100s), and four cards ran 3-5.7x slower than one.  The
  one thread still issues every card's ops, so a call bound by the host's
  issue rate (inserts, deletes, the packed walk) runs on four cards about
  as fast as on one; the full-precision walk, with more device time per
  op, gains (measured on four H100s).
  Steps that make no host decision (attach, label scatter, grow, load,
  the flat scan) run each shard's function once, in shard order.  What
  still waits on a card inside a step is one-off per call: the free-slot
  and delete-membership `torch.nonzero` calls and the ``int(...)`` of
  their sizes here, `delete.mark_deleted`'s copy of the marked ids, and
  `insert_batch`'s boolean-mask writes and its overflow `torch.nonzero`.
- Search uploads the queries once per device and call, runs each shard's
  walk on its device, maps its ids to external ids there, and copies the
  per-shard lists to the first device (the counterpart of `all_gather`),
  where one lexicographic (distance, id) sort over the lists in shard
  order puts overlap copies side by side (`_merge_topk_dedup`).  Deletes
  send the dead ids to every device; each shard finds its copies by a
  membership test of its ``ext`` column (no host id map), repairs the
  referencing rows, and hands the slots to a freelist derived from
  ``~valid`` below the high-water mark.
- An insert or delete call commits on every shard or on none, as the
  reference's one ``shard_map`` program does (`_all_or_none`): each
  shard writes through its own `RowJournal`, and when any shard raises,
  `_fan_out` closes the others and every shard's journal is restored on
  its device, the host bookkeeping with it.
"""

from __future__ import annotations

import contextlib
import inspect
import traceback

import numpy as np
import torch

from diskann_tpu_torch.devices import default_device
from diskann_tpu_torch.graph import delete as delete_mod
from diskann_tpu_torch.graph import packed as packed_mod
from diskann_tpu_torch.graph import state as graph_state
from diskann_tpu_torch.graph.build import insert_batch_steps
from diskann_tpu_torch.graph.config import GraphConfig
from diskann_tpu_torch.graph.scorers import full_precision_scorer, packed_scorer
from diskann_tpu_torch.graph.search import beam_search_scored_steps, beam_search_steps
from diskann_tpu_torch.graph.state import GraphArrays
from diskann_tpu_torch.ops.distance import Metric, distance_to_set, squared_norms
from diskann_tpu_torch.ops.topk import smallest_k, sort_lex, sort_with

# rows repaired or refreshed per call in a delete (the reference's chunk)
_DELETE_CHUNK = 4096
# fat rows rebuilt per call in attach_packed
_ATTACH_ROWS = 65536
# queries walked at once (each query's walk is independent)
_QUERY_ROWS = 8192
# the record's per-shard arrays besides the vectors, as the shards hold them
_HOST_DTYPES = {"sq_norms": torch.float32, "adjacency": torch.int32,
                "degrees": torch.int32, "valid": torch.bool, "vec_sum": torch.float32,
                "ext": torch.int32, "starts": torch.int32}


def _resolve(device) -> torch.device:
    """``device`` as a `torch.device`; a bare "cuda" is pinned to the
    current card, so shards placed by "cuda" and "cuda:0" share a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _placement(shards, device=None) -> list[torch.device]:
    """One device per shard: ``shards`` an int puts every shard on
    ``device`` (the CUDA card by default); a sequence names each shard's
    device and leaves ``device`` unset."""
    if isinstance(shards, (int, np.integer)):
        if shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {shards}")
        return [_resolve(default_device(device))] * int(shards)
    if device is not None:
        raise ValueError("give the devices in `shards` or a shard count and `device`, "
                         "not both")
    devs = [_resolve(d) for d in shards]
    if not devs:
        raise ValueError("no shards")
    return devs


def _record_placement(n_shards: int, device) -> list[torch.device]:
    """The placement of a record's ``n_shards`` shards: ``device`` is one
    device (every shard on it) or a sequence of one device per shard."""
    if device is None or isinstance(device, (str, torch.device)):
        return _placement(n_shards, device)
    devs = _placement(device)
    if len(devs) != n_shards:
        raise ValueError(f"record has {n_shards} shards, {len(devs)} devices given")
    return devs


def _on(dev: torch.device):
    """The device context a shard's step runs under (none on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _fan_out(devices: list, fn) -> list:
    """``[fn(s) for s in range(len(devices))]`` in lockstep, shard ``s``
    run under ``devices[s]``'s context: ``fn(s)`` returns shard s's result
    or a stepping generator (`graph/steps.py`) whose return value is.
    Each round advances every unfinished generator to its next flag, in
    shard order, then reads the round's flags (`_read_flags`) and sends
    each its answer.  Results come back in shard order; the first
    exception propagates once every generator has been closed."""
    out = [None] * len(devices)
    live = {}
    try:
        for s, dev in enumerate(devices):
            with _on(dev):
                r = fn(s)
            if inspect.isgenerator(r):
                live[s] = r
            else:
                out[s] = r
        answers = dict.fromkeys(live)
        while live:
            flags = {}
            for s in list(live):
                with _on(devices[s]):
                    try:
                        flags[s] = live[s].send(answers[s])
                    except StopIteration as stop:
                        out[s] = stop.value
                        del live[s]
            answers = _read_flags(flags)
    finally:
        for g in live.values():
            g.close()
    return out


def _read_flags(flags: dict) -> dict:
    """The host value of each shard's yielded flag: every card's flags are
    copied to pinned host memory behind one event on that card, and each
    card's event is waited on only once every card has its copies queued,
    so no card waits for another's turn."""
    host = {s: f.to("cpu", non_blocking=True) for s, f in flags.items()}
    events = []
    for dev in dict.fromkeys(f.device for f in flags.values() if f.device.type == "cuda"):
        with torch.cuda.device(dev):
            events.append(torch.cuda.Event())
            events[-1].record()
    for ev in events:
        ev.synchronize()
    return {s: h.item() for s, h in host.items()}


def _per_device(devices: list, t: torch.Tensor) -> dict:
    """``t`` copied once to each distinct device of ``devices``."""
    return {dev: t.to(dev) for dev in dict.fromkeys(devices)}


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
    """A Vamana index partitioned into shards, each on its own device.

    Vectors are addressed by EXTERNAL id (assigned at insert, returned by
    `search`); one external id may be stored in several shards (overlap
    routing), and deletes remove every copy."""

    packed: list | None = None
    label_bits: list | None = None
    label_vocab = None
    _labels_per_ext = None
    _labels_stale = False

    def __init__(
        self,
        shards,
        dim: int,
        config: GraphConfig | None = None,
        *,
        cap_per_shard: int = 4096,
        dtype=torch.float32,
        device=None,
    ):
        """``shards``: the shard count, every shard on ``device`` (the CUDA
        card by default), or a sequence of devices, one per shard (shard
        ``s`` on ``shards[s]``); ``dtype``: how the vectors are stored, as
        for `GraphIndex`."""
        self.devices = _placement(shards, device)
        self.device = self.devices[0]          # where the shards' lists merge
        self.n_shards = len(self.devices)
        self.config = config or GraphConfig()
        self.dim = dim
        self.cap_per_shard = cap_per_shard
        self.dtype = graph_state.vector_dtype(dtype)
        r_slack = self.config.max_degree_with_slack
        self.arrays = [graph_state.alloc(cap_per_shard, dim, r_slack, self.dtype, device=d)
                       for d in self.devices]
        # per-shard high-water marks, on the host (the reference keeps them
        # on the mesh)
        self.ns = np.zeros(self.n_shards, np.int64)
        self.starts = [torch.full((1,), -1, dtype=torch.int32, device=d)
                       for d in self.devices]
        self.ext = [torch.full((cap_per_shard,), -1, dtype=torch.int32, device=d)
                    for d in self.devices]
        self.next_ext = 0
        # no host-side external id -> slot map: a delete looks its ids up
        # on the devices, in the `ext` columns
        self.n_deleted = 0
        # freed slots in all shards (each shard's freelist is derived from
        # ~valid below its high-water mark)
        self._free_total = 0

    def shard(self, s: int) -> GraphArrays:
        """Shard ``s``'s arrays, on ``devices[s]``."""
        return self.arrays[s]

    def _fan_out(self, fn) -> list:
        return _fan_out(self.devices, fn)

    def _all_or_none(self, step, undo_packed=None) -> list:
        """`_fan_out` of ``step(s, journal)``, each shard writing through
        its own `RowJournal`.  If any shard raises, every shard's journal
        is restored under its device (shards that had finished too), then
        ``undo_packed(s)`` runs on each, and the host bookkeeping (``ns``,
        ``starts``, ``next_ext``, ``n_deleted``, ``_free_total``) is put
        back before the exception is re-raised."""
        journals = [graph_state.RowJournal() for _ in self.devices]
        host = (self.ns.copy(), list(self.starts), self.next_ext, self.n_deleted,
                self._free_total)
        try:
            return self._fan_out(lambda s: step(s, journals[s]))
        except BaseException as exc:
            # free the failed steps' temporaries before the restore
            traceback.clear_frames(exc.__traceback__)
            for s, (dev, journal) in enumerate(zip(self.devices, journals)):
                with _on(dev):
                    journal.restore()
                    if undo_packed is not None:
                        undo_packed(s)
            (self.ns, self.starts, self.next_ext, self.n_deleted,
             self._free_total) = host
            raise

    # ------------------------------------------------------------------ grow
    def grow(self, new_cap_per_shard: int) -> None:
        """Grow every shard's capacity (pad its arrays); an attached packed
        layout is rebuilt."""
        extra = new_cap_per_shard - self.cap_per_shard
        if extra <= 0:
            return

        def pad(s):
            self.arrays[s] = graph_state.grow(self.arrays[s], new_cap_per_shard)
            self.ext[s] = torch.nn.functional.pad(self.ext[s], (0, extra), value=-1)

        self._fan_out(pad)
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
        silent loss.  Each shard's rows go from the host to its device and
        commit there as one batch (`insert_batch`), freed slots first.
        The call commits on every shard or on none (`_all_or_none`); a
        capacity already grown stays."""
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
            bounds = np.concatenate([[0], np.cumsum(counts)])
            rext = ext_ids.astype(np.int32)

            def insert(s, journal):
                rows = pair_j[bounds[s]:bounds[s + 1]]
                if len(rows):
                    dev = self.devices[s]
                    return self._insert_steps(s, torch.from_numpy(vectors[rows]).to(dev),
                                              torch.from_numpy(rext[rows]).to(dev), journal)

            self._all_or_none(insert)
        self.next_ext += m
        self._labels_stale = True
        return ext_ids

    def _insert_steps(self, s: int, vecs: torch.Tensor, rext: torch.Tensor,
                      journal: graph_state.RowJournal):
        """Shard ``s``'s part of an insert, a stepping generator: freed
        slots first, then the high-water mark."""
        st = self.shard(s)
        dev = self.devices[s]
        n = int(self.ns[s])
        m = vecs.shape[0]
        free = torch.nonzero(~st.valid[:n]).squeeze(1)      # ascending
        take = min(free.shape[0], m)
        slots = torch.cat([free[:take], torch.arange(n, n + m - take, device=dev)])
        slots = slots.to(torch.int32)
        packed = self.packed[s] if self.packed is not None else None
        yield from insert_batch_steps(st, slots, vecs,
                                      torch.ones(m, dtype=torch.bool, device=dev),
                                      self.starts[s], self.config, packed,
                                      journal=journal)
        journal.save(self.ext[s], slots.long())
        self.ext[s][slots.long()] = rext
        self.ns[s] = n + m - take
        self.starts[s] = graph_state.medoid(st, int(self.ns[s]))[None]

    # ---------------------------------------------------------------- delete
    def delete(self, ext_ids) -> None:
        """Delete by external id: every shard finds its copies on its device
        (membership test of its `ext` column), marks them, repairs its
        referencing rows (prune repair, `patch_rows`), clears the deleted
        rows, refreshes an attached packed layout's dirty fat rows, and
        takes a new medoid start (the old one may be among the deleted).
        Freed slots are recycled by later inserts.

        The call commits on every shard or on none (`_all_or_none`).  The
        graph rows, liveness, sum and external ids come back bitwise from
        the journals; the fat rows already refreshed are not journaled
        (nearly every row of a large delete is one) but rebuilt from the
        restored adjacency, which gives them back bitwise wherever they
        matched their adjacency and the current codes (they do after
        `attach_packed` and every update since, until a slot a row still
        names, or slot 0, whose codes fill the empty slots, is reused)."""
        ext_ids = np.unique(np.asarray(ext_ids).ravel().astype(np.int32))
        if len(ext_ids) == 0:
            return
        dead = _per_device(self.devices, torch.from_numpy(ext_ids))
        refreshed = [[] for _ in self.devices]      # fat rows rewritten, per shard

        def delete(s, journal):
            st = self.shard(s)
            hit = torch.isin(self.ext[s], dead[self.devices[s]]) & st.valid
            hit_rows = torch.nonzero(hit).squeeze(1)
            marked = delete_mod.mark_deleted(st, hit_rows, journal=journal)
            journal.save(self.ext[s], hit_rows)
            self.ext[s].masked_fill_(hit, -1)
            aff = delete_mod.rows_referencing_deleted(st)
            rows = torch.nonzero(aff).squeeze(1)
            dirty = torch.nonzero(aff | hit).squeeze(1) if self.packed is not None else None
            for off in range(0, rows.shape[0], _DELETE_CHUNK):
                yield from delete_mod.patch_rows_steps(st, rows[off:off + _DELETE_CHUNK],
                                                       self.config, journal=journal)
            delete_mod.drop_deleted_rows(st, journal=journal)
            if dirty is not None:
                delete_mod.refresh_chunks(self.packed[s], st.adjacency, dirty,
                                          _DELETE_CHUNK, refreshed[s])
            self.starts[s] = graph_state.medoid(st, int(self.ns[s]))[None]
            return int(marked.shape[0])

        def undo_packed(s):
            delete_mod.rebuild_refreshed(self.packed[s], self.arrays[s].adjacency,
                                         refreshed[s])

        self._free_total += sum(self._all_or_none(delete, undo_packed))
        self.n_deleted += len(ext_ids)

    # ---------------------------------------------------------------- packed
    def attach_packed(self, *, dp: int = 64, train_sample=None) -> None:
        """Build each shard's packed fat-row layout on its device (enables
        mode="packed" search).  The projection is trained once, on
        ``train_sample`` or on up to 256 live rows drawn from every
        shard's front."""
        if train_sample is None:
            per = max(1, int(np.ceil(256 / max(self.n_shards, 1))))
            parts = [self.arrays[s].vectors[: min(int(n_s), per)].float().cpu().numpy()
                     for s, n_s in enumerate(self.ns) if n_s > 0]
            train_sample = (np.concatenate(parts, axis=0) if parts
                            else np.zeros((1, self.dim), np.float32))
        proj, pscale, pbias2 = packed_mod.train_packed(
            np.asarray(train_sample, np.float32), min(dp, self.dim),
            self.config.metric, device=self.device,
        )
        self.packed = None      # free the old tables first
        cap = self.cap_per_shard
        trained = {dev: (proj.to(dev), pscale.to(dev), pbias2.to(dev))
                   for dev in dict.fromkeys(self.devices)}

        def attach(s):
            st = self.shard(s)
            ids = torch.arange(cap, device=self.devices[s])
            p = packed_mod.alloc_packed(*trained[self.devices[s]], cap,
                                        self.config.max_degree_with_slack)
            codes, aux = packed_mod.encode(p, st.vectors, self.config.metric)
            packed_mod.set_self_codes(p, ids, codes, aux)
            for off in range(0, cap, _ATTACH_ROWS):
                packed_mod.refresh_rows(p, st.adjacency, ids[off:off + _ATTACH_ROWS])
            return p

        self.packed = self._fan_out(attach)

    # ---------------------------------------------------------------- labels
    def attach_labels(self, labels_per_ext: list) -> None:
        """Assign labels keyed by EXTERNAL id (``labels_per_ext[e]``: the
        label strings of external id e).  Each shard holds the bitset rows
        of its own slots on its device, so filtered search runs
        shard-local.  External ids beyond the list (or added later) carry
        no labels and never match a predicate."""
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
        bits = _per_device(self.devices, ls.bits)

        def scatter(s):
            e, b = self.ext[s], bits[self.devices[s]]
            safe = e.long().clamp(0, b.shape[0] - 1)
            return torch.where((e >= 0)[:, None], b[safe], 0)

        self.label_bits = self._fan_out(scatter)
        self._labels_stale = False

    # ---------------------------------------------------------------- search
    def _merged(self, queries, k, walk):
        """Run ``walk(s, shard, queries)``, a stepping generator returning
        (dists [B, L], local ids [B, L] with -1 where dropped, cmps [B]),
        on every shard, on its device, in lockstep (`_fan_out`),
        map the ids to external ids and merge the lists on the first
        device.  Returns host (dists, ids, cmps summed over the shards)."""
        q = _per_device(self.devices, torch.as_tensor(queries, dtype=torch.float32))
        outs = []
        for off in range(0, q[self.device].shape[0], _QUERY_ROWS):
            def one(s, off=off):
                st = self.shard(s)
                d, ids, c = yield from walk(s, st, q[self.devices[s]][off:off + _QUERY_ROWS])
                safe = ids.long().clamp(0, self.cap_per_shard - 1)
                ok = (ids >= 0) & st.valid[safe]
                return tuple(t.to(self.device) for t in (
                    torch.where(ok, d, float("inf")),
                    torch.where(ok, self.ext[s][safe], -1), c))

            all_d, all_i, cmps = zip(*self._fan_out(one))
            md, mi = _merge_topk_dedup(torch.stack(all_d), torch.stack(all_i), k)
            outs.append((md, mi, sum(cmps)))
        return tuple(torch.cat(t).cpu().numpy() for t in zip(*outs))

    def search(self, queries, k: int, *, l_search: int | None = None,
               mode: str = "full"):
        """Returns (dists [B,k], EXTERNAL ids [B,k], cmps [B] summed over
        the shards).  mode="packed" walks each shard's packed layout
        (attaching one first if needed) and reranks its list at full
        precision before the merge."""
        l = l_search or max(k, self.config.l_build)
        cfg = self.config
        if mode == "packed":
            if self.packed is None:
                self.attach_packed()

            def walk(s, st, qb):
                p = self.packed[s]
                sdef, sdata = packed_scorer(p, cfg.metric)
                res = yield from beam_search_scored_steps(
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
                res = yield from beam_search_steps(
                    st.vectors, st.sq_norms, st.adjacency, self.starts[s], qb,
                    metric=cfg.metric, l_search=l, beam_width=cfg.beam_width,
                    max_hops=cfg.max_hops)
                return res.dists, res.ids, res.cmps
        else:
            raise ValueError(f"unknown search mode {mode!r}")
        return self._merged(queries, k, walk)

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
            res = yield from beam_search_scored_steps(
                sdef, sdata, st.adjacency, self.starts[s], qb, l_search=l,
                beam_width=cfg.beam_width, max_hops=cfg.max_hops,
                history_capacity=cfg.history_capacity(l), accept_fn=accept_fn,
                accept_data=self.label_bits[s], filter_beta=beta,
                filter_mode="inline",
            )
            return res.match_d, res.match_i, res.cmps

        return self._merged(queries, k, walk)

    def search_range(self, queries, radius: float, *,
                     l_init: int | None = None, l_max: int = 1024):
        """All EXTERNAL ids within `radius` of each query (L-doubling rounds
        over every shard, overlap copies deduplicated at the merge)."""
        from diskann_tpu_torch.graph.modes import range_search

        return range_search(self, queries, radius, l_init=l_init, l_max=l_max)

    # -------------------------------------------------------------- save/load
    def _host_arrays(self) -> dict:
        """The record's arrays: each shard's tensors stacked on the host
        into the reference's ``[n_shards, ...]`` layout."""
        stack = lambda ts: np.stack([t.cpu().numpy() for t in ts])  # noqa: E731
        field = lambda f: [getattr(st, f) for st in self.arrays]  # noqa: E731
        out = {"vectors": np.stack([graph_state.vectors_to_host(v)
                                    for v in field("vectors")])}
        out |= {f: stack(field(f))
                for f in ("sq_norms", "adjacency", "degrees", "valid", "vec_sum")}
        out |= {"ext": stack(self.ext), "ns": self.ns.astype(np.int32),
                "starts": stack(self.starts)}
        return out

    def save(self, path: str) -> None:
        """Persist all shards and the external ids in the reference's record
        (kind "sharded_graph_index": the stacked arrays, the eight config
        fields it writes); either package loads it.  Packed layouts and
        labels are not saved, as in the reference."""
        from diskann_tpu_torch.io_.record import save_record

        cfg = self.config
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
            arrays=self._host_arrays(),
            bfloat16=("vectors",) if self.dtype == torch.bfloat16 else (),
        )

    @classmethod
    def load(cls, path: str, *, device=None) -> "ShardedGraphIndex":
        """Load a record written by `save` (of either package) with the
        record's shard count and vector dtype.  ``device``: one device for
        every shard (the CUDA card by default) or a sequence of one device
        per shard, which must match the record's shard count."""
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
        idx = cls(_record_placement(meta["n_shards"], device), meta["dim"], cfg,
                  cap_per_shard=1, dtype=dtype)
        idx._adopt_host(arrays, dtype)
        idx.cap_per_shard = int(meta["cap_per_shard"])
        idx.ns = np.asarray(arrays["ns"], np.int64).copy()
        idx.next_ext = int(meta["next_ext"])
        idx.n_deleted = int(meta.get("n_deleted", 0))
        idx._free_total = int(meta.get("free_total", 0))
        return idx

    def _adopt_host(self, arrays: dict, dtype=None) -> None:
        """Take each shard's slice of the stacked host ``arrays`` (the
        record's `GraphArrays` fields, ``ext`` and ``starts``, writable
        numpy arrays) onto its device."""
        def adopt(s):
            dev = self.devices[s]

            def put(name):
                a = np.ascontiguousarray(arrays[name][s])
                return torch.from_numpy(a).to(dev, _HOST_DTYPES[name])

            self.arrays[s] = GraphArrays(
                vectors=graph_state.vectors_from_host(arrays["vectors"][s], dtype).to(dev),
                **{f: put(f) for f in GraphArrays._fields if f != "vectors"})
            self.ext[s] = put("ext")
            self.starts[s] = put("starts").reshape(1)

        self._fan_out(adopt)


def sharded_flat_search(shards, vectors, queries, k: int,
                        metric: Metric = Metric.L2, *, device=None):
    """Exact top-k over a database cut into blocks of rows, one per shard:
    each block's distances and local top-k on its device, then a merge of
    the blocks' lists on the first device.  Equal distances keep
    ascending id order (each block's top-k does, the blocks are in id
    order and the merge sort is stable), as `FlatIndex` does.

    ``shards``: the block count, every block on ``device`` (default: the
    vectors' device if a tensor, else the CUDA card), or a sequence of
    devices, block ``s`` scanned on ``shards[s]``.  ``vectors`` and
    ``queries``: numpy arrays or tensors.  Returns (dists [B, k'], ids
    [B, k']) tensors on the first device, k' = min(k, the rows the blocks
    offer)."""
    if isinstance(shards, (int, np.integer)) and device is None \
            and isinstance(vectors, torch.Tensor):
        device = vectors.device
    devices = _placement(shards, device)
    n = vectors.shape[0]
    local_n = -(-n // len(devices))
    q = _per_device(devices, torch.as_tensor(queries, dtype=torch.float32))

    def scan(s):
        v = torch.as_tensor(vectors[s * local_n:(s + 1) * local_n], device=devices[s])
        if v.shape[0] == 0:
            return None
        dist = distance_to_set(q[devices[s]], v, metric, x_sq_norms=squared_norms(v))
        dd, cols = smallest_k(dist, min(k, local_n, v.shape[0]))
        return dd.to(devices[0]), (cols.to(torch.int32) + s * local_n).to(devices[0])

    parts = [p for p in _fan_out(devices, scan) if p is not None]
    md, mi = sort_with(torch.cat([p[0] for p in parts], 1),
                       torch.cat([p[1] for p in parts], 1))
    out = min(k, md.shape[1])
    return md[:, :out], mi[:, :out]
