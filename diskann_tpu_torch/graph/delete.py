"""Streaming deletes: in-place delete with repair, and consolidation
(PyTorch port of `diskann_tpu/graph/delete.py`).

A delete clears the nodes' liveness bits, finds the live rows that refer
to them (the in-neighbours), repairs those rows in batches, clears the
deleted nodes' own rows and hands their slots to the index's freelist.
Four ways to find the in-neighbours (``method``):

- ``"scan"``: every live row that holds a deleted id (exact);
- ``"one_hop"``: the deleted nodes' out-lists, kept where they hold a
  deleted id;
- ``"two_hop_one_hop"``: the out-lists and their out-lists, likewise;
- ``"visited_topk"``: a beam search from each deleted vector; its live
  results are the in-neighbour candidates, and its first ``k_value`` live
  results are the replacement candidates for that node.

Two repairs (``repair``): ``"prune"`` RobustPrunes each row's live entries
plus replacement candidates back to R (`patch_rows`); ``"fill"`` drops
the dead entries and tops the row up with the nearest replacements to the
slack width, with no occlusion scan (`fill_rows`).  Replacements for a
dead entry come from its own out-list (the first ``repl_cap`` entries in
the fill), for up to ``max_dead`` dead entries per row.

Every update is in place on the index's tensors.  Only ids that are live
and not repeated in the request are deleted: they alone go on the
freelist and count in ``n_deleted`` (the reference frees every requested
id, so a repeated or already-deleted id is handed out twice later).

A delete commits whole when its caller passes a `RowJournal` and a list
for the refreshed fat rows (`GraphIndex.delete`, `consolidate`): every
writer saves the rows it overwrites in the journal, and the fat rows,
too many to journal (a 5% delete of a large index refreshes nearly every
row), are rebuilt from the restored adjacency (`rebuild_refreshed`).
"""

from __future__ import annotations

import numpy as np
import torch

from diskann_tpu_torch.graph import packed as packed_mod
from diskann_tpu_torch.graph import steps
from diskann_tpu_torch.graph.build import chunked_robust_prune_steps
from diskann_tpu_torch.graph.config import GraphConfig
from diskann_tpu_torch.graph.search import beam_search
from diskann_tpu_torch.graph.state import GraphArrays, RowJournal
from diskann_tpu_torch.ops.distance import distance_to_set
from diskann_tpu_torch.ops.topk import sort_with
from diskann_tpu_torch.trace import span

METHODS = ("scan", "one_hop", "two_hop_one_hop", "visited_topk")
REPAIRS = ("prune", "fill")

# `sd - _KEPT_SHIFT` ranks a kept entry before every replacement.  In
# float32 it rounds to exactly -1e30 for any realistic distance, so all kept
# entries tie and a stable sort leaves them in the ascending-id order of the
# dedup sort before it; the reference's rows come out in that order too.
_KEPT_SHIFT = 1e30

# rows a repair batch and a packed refresh take at a time, by repair
_PATCH_BATCH = {"fill": 4096, "prune": 1024}
# rows a rebuild of refreshed fat rows takes at a time: it runs after a
# failure, under the memory pressure that may have caused it
_UNDO_ROWS = 1024


def _dead(state: GraphArrays, ids: torch.Tensor) -> torch.Tensor:
    """Mask of entries that name a deleted (or never written) node."""
    cap = state.capacity
    return (ids >= 0) & ~state.valid[ids.long().clamp(0, cap - 1)]


def _live(state: GraphArrays, ids: torch.Tensor) -> torch.Tensor:
    cap = state.capacity
    return (ids >= 0) & state.valid[ids.long().clamp(0, cap - 1)]


def mark_deleted(state: GraphArrays, ids, journal: RowJournal | None = None) -> torch.Tensor:
    """Clear the liveness of ``ids`` and take their vectors out of the
    running sum, in place.  Ids outside the table, already deleted or
    repeated are skipped.  Returns the ids marked, [D] int64 on the
    state's device, in the order of their first occurrence.  ``journal``
    keeps the liveness rows and the sum first."""
    ids = np.asarray(torch.as_tensor(ids).cpu(), np.int64).ravel()
    _, first = np.unique(ids, return_index=True)
    ids = ids[np.sort(first)]
    ids = ids[(ids >= 0) & (ids < state.capacity)]
    t = torch.as_tensor(ids, device=state.valid.device)
    t = t[state.valid[t]]
    if journal is not None:
        journal.save(state.valid, t)
        journal.save(state.vec_sum)
    state.valid[t] = False
    state.vec_sum.sub_(state.vectors[t].float().sum(0))
    return t


def rows_referencing_deleted(state: GraphArrays) -> torch.Tensor:
    """[cap] bool — live rows whose adjacency holds a deleted id."""
    return _dead(state, state.adjacency).any(1) & state.valid


def _kept_and_repl(state: GraphArrays, rows, max_dead: int, repl_lookup,
                   repl_table, repl_cap: int = 0):
    """The repair's pool front-end for rows [A] (int64, in range): the
    row's live entries (kept, [A, Rs], -1 elsewhere) and replacement
    candidates ([A, max_dead * width]) for its first ``max_dead`` dead
    entries, from their out-lists (truncated to ``repl_cap`` when
    ``0 < repl_cap < Rs``) or from ``repl_table`` rows looked up by
    ``repl_lookup`` (visited_topk).  A replacement that is deleted or is
    the row itself is -1."""
    cap = state.capacity
    a = rows.shape[0]
    adj = state.adjacency[rows]                                  # [A, Rs]
    kept = torch.where(_live(state, adj), adj, -1)

    # the first max_dead dead entries per row, compacted by rank; column
    # max_dead takes the rest and is cut off
    deadm = _dead(state, adj)
    drank = deadm.cumsum(1) - 1
    dslot = torch.where(deadm & (drank < max_dead), drank, max_dead)
    dead_ids = torch.full((a, max_dead + 1), -1, dtype=torch.int32,
                          device=adj.device)
    dead_ids.scatter_(1, dslot, adj)
    dead_ids = dead_ids[:, :max_dead]
    if repl_table is not None:
        tr = repl_lookup[dead_ids.long().clamp(0, cap)]            # [A, md]
        repl = repl_table[tr.long().clamp(0, repl_table.shape[0] - 1)]
        ok = (dead_ids >= 0) & (tr >= 0)
    else:
        repl = state.adjacency[dead_ids.long().clamp(0, cap - 1)]  # [A, md, Rs]
        if repl_cap and repl_cap < repl.shape[2]:
            repl = repl[:, :, :repl_cap]
        ok = dead_ids >= 0
    repl = torch.where(ok[:, :, None], repl, -1).reshape(a, -1)
    repl = torch.where(_live(state, repl) & (repl != rows[:, None]), repl, -1)
    return kept, repl


def _pool(state: GraphArrays, rows, kept, repl, config: GraphConfig):
    """Pool ids [A, C] = kept | replacements, and each one's distance to
    its row's vector (inf for -1)."""
    cap = state.capacity
    pool_ids = torch.cat([kept, repl], 1)
    p_vec = state.vectors[rows]
    pv = state.vectors[pool_ids.long().clamp(0, cap - 1)]
    pool_d = distance_to_set(p_vec, pv, config.metric)
    return pool_ids, p_vec, torch.where(pool_ids >= 0, pool_d, float("inf"))


def _in_range(state: GraphArrays, rows) -> torch.Tensor:
    rows = torch.as_tensor(rows, device=state.adjacency.device).long()
    return rows[(rows >= 0) & (rows < state.capacity)]


def patch_rows(state: GraphArrays, rows, config: GraphConfig, *,
               max_dead: int = 4, repl_lookup=None,
               repl_table=None) -> GraphArrays:
    """Prune repair of ``rows`` (ids outside the table are skipped), in
    place: RobustPrune each row's live entries plus replacement candidates
    back to R."""
    return steps.run(patch_rows_steps(**locals()))


def patch_rows_steps(state: GraphArrays, rows, config: GraphConfig, *,
                     max_dead: int = 4, repl_lookup=None, repl_table=None,
                     journal: RowJournal | None = None):
    """The stepping form of `patch_rows` (`graph/steps.py`): the prune's
    flags.  ``journal`` keeps the rows before they are written."""
    rows = _in_range(state, rows)
    if rows.numel() == 0:
        return state
    r = config.max_degree
    kept, repl = _kept_and_repl(state, rows, max_dead, repl_lookup, repl_table)
    pool_ids, p_vec, pool_d = _pool(state, rows, kept, repl, config)
    new_ids, _, new_n = yield from chunked_robust_prune_steps(
        state.vectors, p_vec, pool_ids, pool_d, rows.to(torch.int32), config,
        degree=r,
    )
    if journal is not None:
        journal.save(state.adjacency, rows)
        journal.save(state.degrees, rows)
    state.adjacency[rows] = torch.nn.functional.pad(
        new_ids, (0, state.max_degree_slack - r), value=-1)
    state.degrees[rows] = new_n
    return state


def fill_rows(state: GraphArrays, rows, config: GraphConfig, *,
              max_dead: int = 4, repl_lookup=None, repl_table=None,
              repl_cap: int = 16) -> GraphArrays:
    """Prune-free repair of ``rows`` (ids outside the table are skipped),
    in place: keep every live entry, then top the row up with the nearest
    replacement candidates to the slack width.

    Two sorts per row instead of the occlusion scan: one by (id,
    replacement flag) to drop repeats (a kept copy sorts before a
    replacement copy and survives), one by rank key (kept entries first,
    replacements by ascending distance)."""
    rows = _in_range(state, rows)
    if rows.numel() == 0:
        return state
    r_slack = state.max_degree_slack
    kept, repl = _kept_and_repl(state, rows, max_dead, repl_lookup, repl_table,
                                repl_cap)
    pool_ids, _, pool_d = _pool(state, rows, kept, repl, config)

    flag = (torch.arange(pool_ids.shape[1], device=rows.device)
            >= kept.shape[1]).long()
    key, sd = sort_with(pool_ids.long() * 2 + flag, pool_d)
    sid, sflag = key >> 1, key & 1
    dup = torch.nn.functional.pad(sid[:, 1:] == sid[:, :-1], (1, 0), value=False)
    ok = (sid >= 0) & ~dup & torch.isfinite(sd)
    rank = torch.where(ok, torch.where(sflag == 0, sd - _KEPT_SHIFT, sd),
                       float("inf"))
    rank, oid = sort_with(rank, sid)
    new_ids = torch.where(torch.isfinite(rank[:, :r_slack]), oid[:, :r_slack], -1)
    state.adjacency[rows] = new_ids.to(torch.int32)
    state.degrees[rows] = (new_ids >= 0).sum(1, dtype=torch.int32)
    return state


def save_rows(journal: RowJournal | None, state: GraphArrays, rows: torch.Tensor) -> None:
    """Keep the adjacency and degrees of ``rows`` (int64, in range) in
    ``journal`` before the repair batches write them, once for the whole
    call rather than batch by batch: a delete peaks in the discovery scan,
    before the save, and one save costs two ops where a save per batch
    costs two a batch."""
    if journal is not None:
        journal.save(state.adjacency, rows)
        journal.save(state.degrees, rows)


def drop_deleted_rows(state: GraphArrays, journal: RowJournal | None = None) -> GraphArrays:
    """Clear the adjacency rows of deleted nodes, in place.  ``journal``
    keeps the rows this changes first (those not already clear)."""
    gone = ~state.valid
    if journal is not None:
        rows = torch.nonzero(gone & ((state.adjacency != -1).any(1)
                                     | (state.degrees != 0))).squeeze(1)
        journal.save(state.adjacency, rows)
        journal.save(state.degrees, rows)
    state.adjacency.masked_fill_(gone[:, None], -1)
    state.degrees.masked_fill_(gone, 0)
    return state


def refresh_chunks(packed, adjacency: torch.Tensor, rows: torch.Tensor, chunk: int,
                   refreshed: list | None = None) -> None:
    """Rebuild the fat rows of ``rows`` from ``adjacency``, ``chunk`` rows
    a `packed.refresh_rows` call.  Each chunk goes on ``refreshed`` before
    it is written, for `rebuild_refreshed`."""
    for off in range(0, rows.shape[0], chunk):
        part = rows[off:off + chunk]
        if refreshed is not None:
            refreshed.append(part)
        packed_mod.refresh_rows(packed, adjacency, part)


def rebuild_refreshed(packed, adjacency: torch.Tensor, refreshed: list) -> None:
    """The undo of the fat rows a failed call refreshed (the chunks
    `refresh_chunks` put on ``refreshed``): rebuild them from
    ``adjacency`` once the call's journal has restored it, `_UNDO_ROWS`
    rows a call.  A row comes back bitwise wherever it matched its
    adjacency and the current codes before the call, as it does from
    `attach_packed` on until a slot that a row still names, or slot 0
    (whose codes fill the empty slots), is reused."""
    for rows in refreshed:
        refresh_chunks(packed, adjacency, rows, _UNDO_ROWS)


def _uniq(ids: torch.Tensor, cap: int) -> torch.Tensor:
    """The distinct non-negative ids, ascending (a membership mask over the
    capacity, as the reference builds it)."""
    m = torch.zeros(cap, dtype=torch.bool, device=ids.device)
    flat = ids.reshape(-1)
    m[flat[flat >= 0].long()] = True
    return torch.nonzero(m).squeeze(1)


def _rows_that_reference_deleted(state: GraphArrays, rows) -> torch.Tensor:
    """The live rows among ``rows`` whose adjacency holds a deleted id."""
    if rows.numel() == 0:
        return rows
    keep = _dead(state, state.adjacency[rows]).any(1) & state.valid[rows]
    return rows[keep]


def _visited_topk(index, ids, k_value: int, l_value: int | None):
    """visited_topk discovery: a full-precision beam search from each
    deleted vector.  Returns (candidate rows, repl_lookup [cap+1],
    repl_table [D, k_value]): each search's live results, compacted to the
    left, are its node's replacements."""
    st = index.state
    cfg = index.config
    cap = st.capacity
    l = l_value or max(k_value, cfg.l_build)
    res = beam_search(
        st.vectors, st.sq_norms, st.adjacency, index._start(), st.vectors[ids].float(),
        metric=cfg.metric, l_search=l, beam_width=cfg.beam_width,
        max_hops=cfg.max_hops,
    )
    rid = res.ids
    ok = _live(st, rid)
    width = rid.shape[1]
    # live results compacted left by rank; column `width` takes the rest
    slot = torch.where(ok, ok.cumsum(1) - 1, width)
    visited = torch.full((rid.shape[0], width + 1), -1, dtype=torch.int32,
                         device=rid.device)
    visited.scatter_(1, slot, rid)
    visited = visited[:, :width]
    lookup = torch.full((cap + 1,), -1, dtype=torch.int32, device=rid.device)
    lookup[ids] = torch.arange(ids.shape[0], dtype=torch.int32, device=rid.device)
    return _uniq(visited, cap), lookup, visited[:, :k_value].contiguous()


def inplace_delete(index, ids, *, method: str = "scan", k_value: int = 16,
                   l_value: int | None = None, patch_batch: int = 0,
                   repair: str = "prune", max_dead: int = 4,
                   repl_cap: int = 16, journal: RowJournal | None = None,
                   refreshed: list | None = None) -> dict:
    """Delete ``ids`` from a `GraphIndex` in place: mark, find the affected
    rows by ``method``, repair them ``patch_batch`` rows at a time (0 =
    4096 for "fill", 1024 for "prune"), clear the deleted rows, refresh
    the packed rows of both when a packed layout is attached, and put the
    deleted slots on the freelist.  Returns {"deleted": D, "affected": A}.

    max_dead: dead entries per row that contribute replacements (every
    dead entry is dropped).  repl_cap: out-list entries per dead entry in
    the fill repair.  ``journal`` keeps every row the mark, the repairs
    (`save_rows`) and the drop overwrite; ``refreshed`` collects the
    refreshed fat-row chunks (`rebuild_refreshed`).  The freelist and
    ``n_deleted`` are written last, after every step that can fail.  The
    mark through the drop is traced as a ``delete.repair`` span, the
    refresh as ``delete.refresh`` (`trace.py`)."""
    if method not in METHODS:
        raise ValueError(f"unknown delete method {method!r}")
    if repair not in REPAIRS:
        raise ValueError(f"unknown delete repair {repair!r}")
    if method == "visited_topk" and index._hbm_vectors_dropped:
        # raised before anything is marked, where the reference marks first
        raise ValueError("visited_topk needs the full vectors on the device")
    if patch_batch <= 0:
        patch_batch = _PATCH_BATCH[repair]
    st = index.state
    cap = st.capacity
    with span("delete.repair"):
        ids = mark_deleted(st, ids, journal)
        if ids.numel() == 0:
            return {"deleted": 0, "affected": 0}
        # the deleted nodes' out-lists stay intact until drop_deleted_rows
        out_lists = st.adjacency[ids]

        repl_lookup = repl_table = None
        if method == "scan":
            affected = torch.nonzero(rows_referencing_deleted(st)).squeeze(1)
        elif method == "one_hop":
            affected = _rows_that_reference_deleted(st, _uniq(out_lists, cap))
        elif method == "two_hop_one_hop":
            one_hop = _uniq(out_lists, cap)
            cand = _uniq(torch.cat([one_hop[:, None].int(), st.adjacency[one_hop]], 1), cap)
            affected = _rows_that_reference_deleted(st, cand)
        else:
            cand, repl_lookup, repl_table = _visited_topk(index, ids, k_value, l_value)
            affected = _rows_that_reference_deleted(st, cand)

        save_rows(journal, st, affected)
        kw = dict(max_dead=max_dead, repl_lookup=repl_lookup, repl_table=repl_table)
        if repair == "fill":
            kw["repl_cap"] = repl_cap
        repair_fn = fill_rows if repair == "fill" else patch_rows
        for off in range(0, affected.shape[0], patch_batch):
            repair_fn(st, affected[off:off + patch_batch], index.config, **kw)
        drop_deleted_rows(st, journal)
    if index.packed is not None:
        # patched rows changed their neighbourhoods, deleted rows were cleared
        with span("delete.refresh"):
            refresh_chunks(index.packed, st.adjacency, torch.cat([affected, ids]),
                           patch_batch, refreshed)
    freed = ids.tolist()
    index.free_slots.extend(freed)
    index.n_deleted += len(freed)
    return {"deleted": len(freed), "affected": affected.shape[0]}
