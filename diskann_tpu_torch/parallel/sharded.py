"""Database-sharded index over one or several devices (PyTorch port of
`diskann_tpu/parallel/sharded.py`).

- The id space is split into ``n_shards`` ranges of ``cap_per_shard``
  slots; every slot also carries an EXTERNAL id, so one logical vector may
  live in several shards (overlap routing, as `parallel/partition.py`
  assigns it) and results are deduplicated by external id at merge time.
- Placement, the counterpart of the reference's mesh: ``shards`` is an
  int (every shard on ``device``), a sequence of devices, one per shard
  (shard ``s`` on ``shards[s]``; a card may hold several shards), or a
  `parallel/mesh.Mesh` (shard ``s`` in its worker ``s``).  A sequence that
  names more than one CUDA card runs on a `Mesh` of its distinct cards,
  each card's shards in that card's worker process; any other placement
  runs in the calling process.
- Layout: per shard.  The reference stacks each `GraphArrays` field into
  one ``[n_shards, cap, ...]`` array that its mesh splits across devices;
  a torch tensor lives on one device, so each shard owns its own
  `GraphArrays`, external ids ([cap] int32), start ([1] int32), label
  bits and packed table, all on its device, held by a `_Shards`: one for
  every shard in the calling process, or one per card in the card's
  worker (`mesh.MeshShards` forwards the same calls there).  The
  high-water marks ``ns`` and the counters live on the host, in the
  calling process.  The record is written by each shard straight into
  its slice of the stacked files, so it stays the reference's byte for
  byte.  The port's own per-index calls run on a shard unchanged: the
  stepping forms of `graph/build.insert_batch`, `graph/search.beam_search`
  and `beam_search_scored` and `graph/delete.patch_rows`, `graph/delete`'s
  mark and `drop_deleted_rows`, and `graph/packed`'s `alloc_packed` /
  `encode` / `refresh_rows`.
- Fan-out within a process, the counterpart of `shard_map` on the shards
  one process holds (`_fan_out`): one host thread drives its shards in
  lockstep.  A shard's work is a stepping generator (`graph/steps.py`:
  the hop loop, the occlusion scan and the insert and repair that compose
  them yield each "go on?" flag instead of reading it); each round
  advances every shard to its next flag in shard order, which queues that
  step on the shard's card, then copies the flags to the host behind one
  event per card and sends each its answer.  On a mesh, each card's
  worker runs this loop over its own shards, so every card has a host
  thread of its own that issues only its ops: the counterpart of the
  reference's one program per chip.  A command crosses to every worker
  before any reply is read, and only the command and its result cross
  processes.  (One thread issuing every card's ops ran inserts, deletes
  and the packed walk on four cards about as fast as on one; threads in
  one interpreter, handing its lock back and forth, left each card idle
  ~93% of an insert call: both traced on four H100s.)
  Steps that make no host decision (attach, label scatter, grow, load,
  the flat scan) run each shard's function once, in shard order.  What
  still waits on a card inside a step is one-off per call: the free-slot
  and delete-membership `torch.nonzero` calls and the ``int(...)`` of
  their sizes here, `delete.mark_deleted`'s copy of the marked ids, and
  `insert_batch`'s boolean-mask writes and its overflow `torch.nonzero`.
- Search runs each shard's walk on its device, maps its ids to external
  ids there, and brings the per-shard lists to the first device (the
  counterpart of `all_gather`; from a worker by CUDA IPC and a peer
  copy), where one
  lexicographic (distance, id) sort over the lists in shard order puts
  overlap copies side by side (`_merge_topk_dedup`).  Deletes send the
  dead ids to every shard; each finds its copies by a membership test of
  its ``ext`` column (no host id map), repairs the referencing rows, and
  hands the slots to a freelist derived from ``~valid`` below the
  high-water mark.
- An insert or delete call commits on every shard or on none, as the
  reference's one ``shard_map`` program does (`_all_or_none`): each
  shard writes through its own `RowJournal` and keeps it until the call
  is settled.  When any shard raises, every shard's journal is restored
  on its device (in every worker, those that finished too), and the host
  bookkeeping with it; otherwise every journal is dropped.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import inspect
import json
import os
import traceback

import numpy as np
import torch

from diskann_tpu_torch import trace
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
# the record's arrays, in its order ("ns" is the host's)
_RECORD = ("vectors", "sq_norms", "adjacency", "degrees", "valid", "vec_sum", "ext", "ns",
           "starts")


def _resolve(device) -> torch.device:
    """``device`` as a `torch.device`; a bare "cuda" is pinned to the
    current card, so shards placed by "cuda" and "cuda:0" share a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _is_mesh(obj) -> bool:
    from diskann_tpu_torch.parallel.mesh import Mesh

    return isinstance(obj, Mesh)


def _placement(shards, device=None) -> list[torch.device]:
    """One device per shard: ``shards`` an int puts every shard on
    ``device`` (the CUDA card by default); a sequence names each shard's
    device, and a `Mesh` puts shard ``s`` on its device ``s``; both leave
    ``device`` unset."""
    if isinstance(shards, (int, np.integer)):
        if shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {shards}")
        return [_resolve(default_device(device))] * int(shards)
    if device is not None:
        raise ValueError("give the devices in `shards` or a shard count and `device`, "
                         "not both")
    devs = [_resolve(d) for d in (shards.devices if _is_mesh(shards) else shards)]
    if not devs:
        raise ValueError("no shards")
    return devs


def _spans_cards(devices: list) -> bool:
    """Whether a device list runs on a mesh: it names more than one CUDA
    card."""
    return len({d for d in devices if d.type == "cuda"}) > 1


def _record_placement(n_shards: int, device):
    """The placement of a record's ``n_shards`` shards: ``device`` is one
    device (every shard on it), a sequence of one device per shard, or a
    `Mesh` of one worker per shard."""
    if device is None or isinstance(device, (str, torch.device)):
        return _placement(n_shards, device)
    devs = _placement(device)
    if len(devs) != n_shards:
        raise ValueError(f"record has {n_shards} shards, {len(devs)} devices given")
    return device if _is_mesh(device) else devs


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
    exception propagates once every generator has been closed.  Each
    shard's trace spans nest on a stack of its own (`trace.fork`)."""
    out = [None] * len(devices)
    live = {}
    stacks = trace.fork(len(devices))
    try:
        for s, dev in enumerate(devices):
            with _on(dev), trace.resume(stacks, s):
                r = fn(s)
            if inspect.isgenerator(r):
                live[s] = r
            else:
                out[s] = r
        answers = dict.fromkeys(live)
        while live:
            flags = {}
            for s in list(live):
                with _on(devices[s]), trace.resume(stacks, s):
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
    so no card waits for another's turn.  One ``sync`` wait of `trace.py`
    a round that has flags."""
    if not flags:
        return {}
    with trace.wait("sync"):
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


def _record_layout(n_shards: int, cap: int, dim: int, r_slack: int, dtype) -> dict:
    """The record's arrays: name -> (numpy dtype, shape of the stack)."""
    host = graph_state.vectors_to_host(torch.empty(0, dtype=dtype)).dtype
    return {"vectors": (host, (n_shards, cap, dim)),
            "sq_norms": (np.float32, (n_shards, cap)),
            "adjacency": (np.int32, (n_shards, cap, r_slack)),
            "degrees": (np.int32, (n_shards, cap)), "valid": (np.bool_, (n_shards, cap)),
            "vec_sum": (np.float32, (n_shards, dim)), "ext": (np.int32, (n_shards, cap)),
            "ns": (np.int32, (n_shards,)), "starts": (np.int32, (n_shards, 1))}


class _Shards:
    """The device state of some shards of a `ShardedGraphIndex`, and the
    work each call does on them: every shard, in the calling process, or
    one card's shards, in that card's mesh worker (`parallel/mesh.py`).
    ``ids`` are the shards' global numbers; a list passed in or returned
    holds one entry per shard held here, in that order."""

    def __init__(self, ids, devices, dim: int, config: GraphConfig, cap: int, dtype):
        self.ids = list(ids)
        self.devices = list(devices)
        self.dim, self.config, self.cap, self.dtype = dim, config, cap, dtype
        r_slack = config.max_degree_with_slack
        self.arrays = [graph_state.alloc(cap, dim, r_slack, dtype, device=d)
                       for d in self.devices]
        self.starts = [torch.full((1,), -1, dtype=torch.int32, device=d) for d in self.devices]
        self.ext = [torch.full((cap,), -1, dtype=torch.int32, device=d) for d in self.devices]
        self.packed = None
        self.label_bits = None
        # a call's journals, the starts before it and its refreshed fat
        # rows (a delete's), until `settle`
        self._pending = None

    def _fan_out(self, fn) -> list:
        return _fan_out(self.devices, fn)

    def copy(self) -> "_Shards":
        """A copy on fresh tensors (the packed projection shared)."""
        c = copy.copy(self)
        c.arrays = [GraphArrays(*(t.clone() for t in st)) for st in self.arrays]
        c.ext = [e.clone() for e in self.ext]
        c.starts = [t.clone() for t in self.starts]
        if self.packed is not None:
            c.packed = [dataclasses.replace(p, self_codes=p.self_codes.clone(),
                                            self_aux=p.self_aux.clone(), rows=p.rows.clone())
                        for p in self.packed]
        if self.label_bits is not None:
            c.label_bits = [b.clone() for b in self.label_bits]
        c._pending = None
        return c

    def fetch(self, name: str, s: int | None = None):
        """Each shard's ``name`` ("arrays", "ext", "starts", "packed",
        "label_bits"), or shard ``s``'s alone."""
        got = getattr(self, name)
        got = [None] * len(self.ids) if got is None else list(got)
        return got if s is None else got[self.ids.index(s)]

    def run(self, fn, *args) -> list:
        return [fn(self, *args)]

    # ---------------------------------------------------------------- grow
    def grow(self, cap: int) -> None:
        extra = cap - self.cap

        def pad(i):
            self.arrays[i] = graph_state.grow(self.arrays[i], cap)
            self.ext[i] = torch.nn.functional.pad(self.ext[i], (0, extra), value=-1)

        self._fan_out(pad)
        self.cap = cap

    # ---------------------------------------------- insert / delete, settled
    def step(self, args: list, name: str) -> list:
        """`_fan_out` of the call ``name`` ("insert" or "delete"), shard i
        given ``args[i]`` and a `RowJournal` of its own, kept (with the
        starts before the call) until `settle`."""
        journals = [graph_state.RowJournal() for _ in self.devices]
        refreshed = [[] for _ in self.devices] if name == "delete" else None
        self._pending = (journals, list(self.starts), refreshed)
        work = getattr(self, f"_{name}")
        return self._fan_out(lambda i: work(i, journals[i], *args[i]))

    def settle(self, ok: bool) -> None:
        """Commit the pending call (drop its journals) or, with ``ok``
        false, restore every shard's journal on its device, rebuild the fat
        rows a delete refreshed, and put the starts back."""
        journals, starts, refreshed = self._pending
        self._pending = None
        if ok:
            for journal in journals:
                journal.drop()
            return
        for i, (dev, journal) in enumerate(zip(self.devices, journals)):
            with _on(dev):
                journal.restore()
                if refreshed is not None and self.packed is not None:
                    delete_mod.rebuild_refreshed(self.packed[i], self.arrays[i].adjacency,
                                                 refreshed[i])
        self.starts = starts

    def _insert(self, i: int, journal, n: int, rows):
        """Shard i's part of an insert (``rows``: its vectors and external
        ids, or None): its high-water mark after it."""
        if rows is None:
            return n
        return self._insert_steps(i, journal, n, *rows)

    def _insert_steps(self, i: int, journal, n: int, vectors, rext):
        """A stepping generator: freed slots first, then the high-water
        mark."""
        dev = self.devices[i]
        vecs = torch.from_numpy(vectors).to(dev)
        rext = torch.from_numpy(rext).to(dev)
        st = self.arrays[i]
        m = vecs.shape[0]
        free = torch.nonzero(~st.valid[:n]).squeeze(1)      # ascending
        take = min(free.shape[0], m)
        slots = torch.cat([free[:take], torch.arange(n, n + m - take, device=dev)])
        slots = slots.to(torch.int32)
        packed = self.packed[i] if self.packed is not None else None
        with trace.span("insert.batch", shard=i, rows=m):
            yield from insert_batch_steps(st, slots, vecs,
                                          torch.ones(m, dtype=torch.bool, device=dev),
                                          self.starts[i], self.config, packed,
                                          journal=journal)
        journal.save(self.ext[i], slots.long())
        self.ext[i][slots.long()] = rext
        n = n + m - take
        self.starts[i] = graph_state.medoid(st, n)[None]
        return n

    def _delete(self, i: int, journal, n: int, ext_ids):
        """Shard i's part of a delete, a stepping generator: the slots it
        marked."""
        st = self.arrays[i]
        hit = torch.isin(self.ext[i], torch.from_numpy(ext_ids).to(self.devices[i])) & st.valid
        hit_rows = torch.nonzero(hit).squeeze(1)
        marked = delete_mod.mark_deleted(st, hit_rows, journal=journal)
        journal.save(self.ext[i], hit_rows)
        self.ext[i].masked_fill_(hit, -1)
        aff = delete_mod.rows_referencing_deleted(st)
        rows = torch.nonzero(aff).squeeze(1)
        dirty = torch.nonzero(aff | hit).squeeze(1) if self.packed is not None else None
        for off in range(0, rows.shape[0], _DELETE_CHUNK):
            yield from delete_mod.patch_rows_steps(st, rows[off:off + _DELETE_CHUNK],
                                                   self.config, journal=journal)
        delete_mod.drop_deleted_rows(st, journal=journal)
        if dirty is not None:
            delete_mod.refresh_chunks(self.packed[i], st.adjacency, dirty,
                                      _DELETE_CHUNK, self._pending[2][i])
        self.starts[i] = graph_state.medoid(st, n)[None]
        return int(marked.shape[0])

    # ---------------------------------------------------------------- packed
    def train_rows(self, takes: list) -> list:
        """The first ``takes[i]`` vectors of each shard, as float32 numpy."""
        return [self.arrays[i].vectors[:t].float().cpu().numpy() for i, t in enumerate(takes)]

    def attach_packed(self, proj, pscale, pbias2) -> None:
        """Each shard's packed fat-row layout, built on its device with the
        trained projection."""
        self.packed = None      # free the old tables first
        cap = self.cap
        trained = {dev: tuple(torch.as_tensor(t).to(dev) for t in (proj, pscale, pbias2))
                   for dev in dict.fromkeys(self.devices)}

        def attach(i):
            st = self.arrays[i]
            ids = torch.arange(cap, device=self.devices[i])
            p = packed_mod.alloc_packed(*trained[self.devices[i]], cap,
                                        self.config.max_degree_with_slack)
            codes, aux = packed_mod.encode(p, st.vectors, self.config.metric)
            packed_mod.set_self_codes(p, ids, codes, aux)
            for off in range(0, cap, _ATTACH_ROWS):
                packed_mod.refresh_rows(p, st.adjacency, ids[off:off + _ATTACH_ROWS])
            return p

        self.packed = self._fan_out(attach)

    # ---------------------------------------------------------------- labels
    def scatter_labels(self, bits) -> None:
        """Each shard's label rows, ``bits[e]`` at every slot of external id
        e (none at empty slots)."""
        bits = _per_device(self.devices, torch.as_tensor(bits))

        def scatter(i):
            e, b = self.ext[i], bits[self.devices[i]]
            safe = e.long().clamp(0, b.shape[0] - 1)
            return torch.where((e >= 0)[:, None], b[safe], 0)

        self.label_bits = self._fan_out(scatter)

    # ---------------------------------------------------------------- search
    def walk(self, queries, mode: str, k: int, l: int, filt=None, dest=None) -> list:
        """Each shard's (dists [B, k or L], EXTERNAL ids with -1 where
        dropped, cmps [B]) for ``queries`` (mode "full", "packed" or
        "filtered" with ``filt`` = (predicate, vocab, beta)), moved to
        ``dest`` if given."""
        cfg = self.config
        q = _per_device(self.devices, torch.as_tensor(queries, dtype=torch.float32))
        if mode == "packed":
            def walk(i, st, qb):
                p = self.packed[i]
                sdef, sdata = packed_scorer(p, cfg.metric)
                res = yield from beam_search_scored_steps(
                    sdef, sdata, st.adjacency, self.starts[i], qb, l_search=l,
                    beam_width=cfg.beam_width, max_hops=cfg.max_hops,
                    dedup="merge", expand_r=p.r_pack,
                )
                # local full-precision rerank before the merge
                safe = res.ids.long().clamp(0, self.cap - 1)
                dd = distance_to_set(qb, st.vectors[safe], cfg.metric,
                                     x_sq_norms=st.sq_norms[safe])
                dd = torch.where((res.ids >= 0) & st.valid[safe], dd, float("inf"))
                dd, ii = sort_with(dd, res.ids)
                return dd[:, :k], ii[:, :k], res.cmps
        elif mode == "full":
            def walk(i, st, qb):
                res = yield from beam_search_steps(
                    st.vectors, st.sq_norms, st.adjacency, self.starts[i], qb,
                    metric=cfg.metric, l_search=l, beam_width=cfg.beam_width,
                    max_hops=cfg.max_hops)
                return res.dists, res.ids, res.cmps
        else:
            from diskann_tpu_torch.filters import compile_accept

            predicate, vocab, beta = filt
            accept_fn = compile_accept(predicate, vocab, self.cap)

            def walk(i, st, qb):
                sdef, sdata = full_precision_scorer(st.vectors, st.sq_norms, cfg.metric)
                res = yield from beam_search_scored_steps(
                    sdef, sdata, st.adjacency, self.starts[i], qb, l_search=l,
                    beam_width=cfg.beam_width, max_hops=cfg.max_hops,
                    history_capacity=cfg.history_capacity(l), accept_fn=accept_fn,
                    accept_data=self.label_bits[i], filter_beta=beta,
                    filter_mode="inline",
                )
                return res.match_d, res.match_i, res.cmps

        def one(i):
            st = self.arrays[i]
            d, ids, c = yield from walk(i, st, q[self.devices[i]])
            safe = ids.long().clamp(0, self.cap - 1)
            ok = (ids >= 0) & st.valid[safe]
            out = (torch.where(ok, d, float("inf")), torch.where(ok, self.ext[i][safe], -1), c)
            return out if dest is None else tuple(t.to(dest) for t in out)

        return self._fan_out(one)

    # -------------------------------------------------------------- save/load
    def host_arrays(self) -> list:
        """Each shard's record arrays on the host (all but "ns")."""
        out = []
        for st, e, s0 in zip(self.arrays, self.ext, self.starts):
            a = {"vectors": graph_state.vectors_to_host(st.vectors)}
            a |= {f: getattr(st, f).cpu().numpy()
                  for f in ("sq_norms", "adjacency", "degrees", "valid", "vec_sum")}
            out.append(a | {"ext": e.cpu().numpy(), "starts": s0.cpu().numpy()})
        return out

    def write_record(self, path: str) -> None:
        """Write each shard's slice of the record's stacked files (made to
        their full size by the caller) at its offset, one shard at a
        time."""
        for s, arrays in zip(self.ids, self.host_arrays()):
            for name, a in arrays.items():
                a = np.ascontiguousarray(a)
                with open(os.path.join(path, f"{name}.bin"), "r+b") as f:
                    f.seek(s * a.nbytes)
                    a.tofile(f)

    def read_record(self, path: str) -> None:
        """Take each shard's slice of the record at ``path`` onto its
        device (the files mapped, not read whole)."""
        from diskann_tpu_torch.io_.record import load_record

        _, arrays = load_record(path, mmap=True)
        self.adopt([{name: np.array(arrays[name][s]) for name in _RECORD if name != "ns"}
                    for s in self.ids])

    def adopt(self, parts: list) -> None:
        """Take each shard's record arrays (``parts[i]``: the `GraphArrays`
        fields, "ext" and "starts", writable numpy arrays) onto its
        device."""
        def adopt(i):
            dev, a = self.devices[i], parts[i]

            def put(name):
                return torch.from_numpy(np.ascontiguousarray(a[name])).to(dev, _HOST_DTYPES[name])

            self.arrays[i] = GraphArrays(
                vectors=graph_state.vectors_from_host(a["vectors"], self.dtype).to(dev),
                **{f: put(f) for f in GraphArrays._fields if f != "vectors"})
            self.ext[i] = put("ext")
            self.starts[i] = put("starts").reshape(1)

        self._fan_out(adopt)
        self.cap = self.arrays[0].capacity

    def adopt_packed(self, parts: list, r_pack: int) -> None:
        """Each shard's packed table from the reference's (``parts[i]``:
        the `PackedState` fields as numpy arrays)."""
        from diskann_tpu_torch.convert import _PACKED_DTYPES, _tensor

        self.packed = [packed_mod.PackedState(
            **{f: _tensor(p[f], dt, dev) for f, dt in _PACKED_DTYPES.items()}, r_pack=r_pack)
            for p, dev in zip(parts, self.devices)]

    def adopt_labels(self, parts: list) -> None:
        """Each shard's label rows from the reference's (uint32 words)."""
        from diskann_tpu_torch.convert import _tensor

        self.label_bits = [_tensor(b, torch.int32, dev) for b, dev in zip(parts, self.devices)]


class ShardedGraphIndex:
    """A Vamana index partitioned into shards, each on its own device.

    Vectors are addressed by EXTERNAL id (assigned at insert, returned by
    `search`); one external id may be stored in several shards (overlap
    routing), and deletes remove every copy."""

    label_vocab = None
    _labels_per_ext = None
    _labels_stale = False
    # the packed width attached (None: no packed layout)
    _packed_dp = None

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
        card by default); a sequence of devices, one per shard (shard ``s``
        on ``shards[s]``), which runs on a `Mesh` of its distinct cards when
        it names more than one CUDA card; or a `Mesh`, one shard in each of
        its workers.  ``dtype``: how the vectors are stored, as for
        `GraphIndex`."""
        self.devices = _placement(shards, device)
        self.device = self.devices[0]          # where the shards' lists merge
        self.n_shards = len(self.devices)
        self.config = config or GraphConfig()
        self.dim = dim
        self.cap_per_shard = cap_per_shard
        self.dtype = graph_state.vector_dtype(dtype)
        spec = dict(dim=dim, config=self.config, cap=cap_per_shard, dtype=self.dtype)
        self.mesh = None
        if _is_mesh(shards):
            self.mesh = shards
            workers = list(range(self.n_shards))
        elif not isinstance(shards, (int, np.integer)) and _spans_cards(self.devices):
            from diskann_tpu_torch.parallel.mesh import Mesh

            cards = list(dict.fromkeys(self.devices))
            self.mesh = Mesh(cards)
            workers = [cards.index(d) for d in self.devices]
        if self.mesh is None:
            self._shards = _Shards(range(self.n_shards), self.devices, **spec)
        else:
            from diskann_tpu_torch.parallel.mesh import MeshShards

            self._shards = MeshShards(self.mesh, workers, self.devices, **spec)
        # per-shard high-water marks, on the host (the reference keeps them
        # on the mesh)
        self.ns = np.zeros(self.n_shards, np.int64)
        self.next_ext = 0
        # no host-side external id -> slot map: a delete looks its ids up
        # on the devices, in the `ext` columns
        self.n_deleted = 0
        # freed slots in all shards (each shard's freelist is derived from
        # ~valid below its high-water mark)
        self._free_total = 0

    # Each shard's state, by shard; on a mesh, views of (on the CPU, copies
    # of) the worker's tensors, for reading only.
    @property
    def arrays(self) -> list:
        return self._shards.fetch("arrays")

    @property
    def ext(self) -> list:
        return self._shards.fetch("ext")

    @property
    def starts(self) -> list:
        return self._shards.fetch("starts")

    @property
    def packed(self) -> list | None:
        return None if self._packed_dp is None else self._shards.fetch("packed")

    @property
    def label_bits(self) -> list | None:
        return None if self._labels_per_ext is None else self._shards.fetch("label_bits")

    def shard(self, s: int) -> GraphArrays:
        """Shard ``s``'s arrays, on ``devices[s]`` (on a mesh, for reading
        only)."""
        return self._shards.fetch("arrays", s)

    def _run(self, fn, *args) -> list:
        """``fn(shards, *args)`` on each `_Shards` of this index: the one in
        this process, or each worker's (a function importable by name
        there).  Returns the results, one per `_Shards`."""
        return self._shards.run(fn, *args)

    def _copy(self) -> "ShardedGraphIndex":
        """A copy on fresh tensors (on a mesh, in the same workers)."""
        c = copy.copy(self)
        c.ns = self.ns.copy()
        c._shards = self._shards.copy()
        if self._labels_per_ext is not None:
            c._labels_per_ext = list(self._labels_per_ext)
        return c

    def _all_or_none(self, name: str, args: list) -> list:
        """The call ``name`` on every shard (``args[s]``: shard s's
        arguments), each writing through its own `RowJournal`, then
        settled: committed on every shard if none raised; else every
        shard's journal restored (shards that had finished too, in every
        worker), the fat rows a delete refreshed rebuilt, and the host
        bookkeeping (``ns``, ``next_ext``, ``n_deleted``, ``_free_total``)
        put back before the exception is re-raised."""
        host = (self.ns.copy(), self.next_ext, self.n_deleted, self._free_total)
        try:
            out = self._shards.step(args, name)
        except BaseException as exc:
            # free the failed steps' temporaries before the restore
            traceback.clear_frames(exc.__traceback__)
            try:
                self._shards.settle(False)
            finally:
                self.ns, self.next_ext, self.n_deleted, self._free_total = host
            raise
        self._shards.settle(True)
        return out

    # ------------------------------------------------------------------ grow
    def grow(self, new_cap_per_shard: int) -> None:
        """Grow every shard's capacity (pad its arrays); an attached packed
        layout is rebuilt."""
        if new_cap_per_shard <= self.cap_per_shard:
            return
        self._shards.grow(new_cap_per_shard)
        self.cap_per_shard = new_cap_per_shard
        self._labels_stale = True
        if self._packed_dp is not None:
            self.attach_packed(dp=self._packed_dp)

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
            args = []
            for s in range(self.n_shards):
                rows = pair_j[bounds[s]:bounds[s + 1]]
                args.append((int(self.ns[s]), (vectors[rows], rext[rows]) if len(rows) else None))
            self.ns = np.asarray(self._all_or_none("insert", args), np.int64)
        self.next_ext += m
        self._labels_stale = True
        return ext_ids

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
        args = [(int(n), ext_ids) for n in self.ns]
        self._free_total += sum(self._all_or_none("delete", args))
        self.n_deleted += len(ext_ids)

    # ---------------------------------------------------------------- packed
    def attach_packed(self, *, dp: int = 64, train_sample=None) -> None:
        """Build each shard's packed fat-row layout on its device (enables
        mode="packed" search).  The projection is trained once, on
        ``train_sample`` or on up to 256 live rows drawn from every
        shard's front."""
        if train_sample is None:
            per = max(1, int(np.ceil(256 / max(self.n_shards, 1))))
            parts = [p for p, n_s in zip(
                self._shards.train_rows([min(int(n_s), per) for n_s in self.ns]), self.ns)
                if n_s > 0]
            train_sample = (np.concatenate(parts, axis=0) if parts
                            else np.zeros((1, self.dim), np.float32))
        proj, pscale, pbias2 = packed_mod.train_packed(
            np.asarray(train_sample, np.float32), min(dp, self.dim),
            self.config.metric, device=self.device,
        )
        self._packed_dp = None
        self._shards.attach_packed(proj, pscale, pbias2)
        self._packed_dp = int(proj.shape[1])

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
        self._shards.scatter_labels(ls.bits)
        self._labels_stale = False

    # ---------------------------------------------------------------- search
    def _merged(self, queries, k, mode, l, filt=None):
        """Run every shard's walk of ``mode`` (`_Shards.walk`) on its
        device, in lockstep within each process, bring the lists to the
        first device and merge them there.  Returns host (dists, ids, cmps
        summed over the shards)."""
        q = queries if isinstance(queries, torch.Tensor) else np.asarray(queries, np.float32)
        outs = []
        for off in range(0, q.shape[0], _QUERY_ROWS):
            lists = self._shards.walk(q[off:off + _QUERY_ROWS], mode, k, l, filt, self.device)
            all_d, all_i, cmps = zip(*lists)
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
        if mode not in ("full", "packed"):
            raise ValueError(f"unknown search mode {mode!r}")
        if mode == "packed" and self._packed_dp is None:
            self.attach_packed()
        return self._merged(queries, k, mode, l)

    def search_filtered(self, queries, predicate, k: int = 10, *,
                        l_search: int | None = None,
                        filter_beta: float | None = None):
        """Label-filtered k-NN over every shard (the inline beta filter;
        the matched lists merge with external-id dedup).  Returns (true
        dists [B,k], EXTERNAL ids [B,k], cmps [B] summed over the shards)."""
        from diskann_tpu_torch.filters import parse_predicate

        if self._labels_per_ext is None:
            raise ValueError("attach_labels first")
        if self._labels_stale:
            self._rebuild_label_bits()
        if isinstance(predicate, str):
            predicate = parse_predicate(predicate)
        l = l_search or max(k, self.config.l_build)
        beta = filter_beta if filter_beta is not None else 0.5
        return self._merged(queries, k, "filtered", l, (predicate, self.label_vocab, beta))

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
        parts = self._shards.host_arrays()
        out = {name: np.stack([p[name] for p in parts]) for name in _RECORD if name != "ns"}
        out["ns"] = self.ns.astype(np.int32)
        return {name: out[name] for name in _RECORD}

    def save(self, path: str) -> None:
        """Persist all shards and the external ids in the reference's record
        (kind "sharded_graph_index": the stacked arrays, the eight config
        fields it writes); either package loads it.  Each shard writes its
        slice of the stacked files from its own process.  Packed layouts
        and labels are not saved, as in the reference."""
        from diskann_tpu_torch.io_.record import FORMAT_VERSION

        cfg = self.config
        layout = _record_layout(self.n_shards, self.cap_per_shard, self.dim,
                                cfg.max_degree_with_slack, self.dtype)
        os.makedirs(path, exist_ok=True)
        for name, (dt, shape) in layout.items():
            with open(os.path.join(path, f"{name}.bin"), "wb") as f:
                f.truncate(int(np.prod(shape)) * np.dtype(dt).itemsize)
        self.ns.astype(np.int32).tofile(os.path.join(path, "ns.bin"))
        self._shards.write_record(path)
        meta = {
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
        }
        artifacts = {name: {"file": f"{name}.bin",
                            "dtype": ("bfloat16" if name == "vectors"
                                      and self.dtype == torch.bfloat16 else str(np.dtype(dt))),
                            "shape": list(shape)}
                     for name, (dt, shape) in layout.items()}
        # the manifest `io_.record.save_record` writes after its artifacts
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump({"format_version": FORMAT_VERSION, "kind": "sharded_graph_index",
                       "meta": meta, "artifacts": artifacts}, f, indent=2)

    @classmethod
    def load(cls, path: str, *, device=None) -> "ShardedGraphIndex":
        """Load a record written by `save` (of either package) with the
        record's shard count and vector dtype.  ``device``: one device for
        every shard (the CUDA card by default), a sequence of one device
        per shard, which must match the record's shard count (more than one
        CUDA card: on a `Mesh`, each worker reading its shards' slices of
        the files), or a `Mesh` of one worker per shard."""
        from diskann_tpu_torch.io_.record import load_record

        manifest, arrays = load_record(path, mmap=True)
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
        idx._shards.read_record(path)
        idx.cap_per_shard = int(meta["cap_per_shard"])
        idx.ns = np.asarray(arrays["ns"], np.int64).copy()
        idx.next_ext = int(meta["next_ext"])
        idx.n_deleted = int(meta.get("n_deleted", 0))
        idx._free_total = int(meta.get("free_total", 0))
        return idx

    def _adopt_host(self, arrays: dict) -> None:
        """Take each shard's slice of the stacked host ``arrays`` (the
        record's `GraphArrays` fields, ``ext`` and ``starts``) onto its
        device."""
        self._shards.adopt([{name: np.array(a[s]) for name, a in arrays.items()}
                            for s in range(self.n_shards)])
        self.cap_per_shard = int(np.shape(arrays["ext"])[1])


def sharded_flat_search(shards, vectors, queries, k: int,
                        metric: Metric = Metric.L2, *, device=None):
    """Exact top-k over a database cut into blocks of rows, one per shard:
    each block's distances and local top-k on its device, then a merge of
    the blocks' lists on the first device.  Equal distances keep
    ascending id order (each block's top-k does, the blocks are in id
    order and the merge sort is stable), as `FlatIndex` does.  It holds no
    state, so it runs in the calling process on every placement.

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
