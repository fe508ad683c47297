"""Batched Vamana construction — the `multi_insert` path (PyTorch port of
`diskann_tpu/graph/build.py`).

A batch is committed in three phases, each over the whole batch as dense
tensors:

  1. set elements — write the batch's vectors (and int8 codes);
  2. candidate generation — one beam search (router-seeded over the packed
     fat-row table, or full precision from the start points when the
     index has no packed layout), plus intra-batch candidates, then one
     batched RobustPrune on full-precision vectors;
  3. graph update — commit out-edges (3a), append backedges by target with
     a sort + segmented rank (3b), re-prune overfull targets (3c); a
     packed table follows every change (`refresh_rows`, `append_edges`).

Phase 2 is traced as an ``insert.candidates`` span, phase 3 as
``insert.edges`` (`trace.py`).

The graph and packed tables are updated in place: the reference donated
them to its jitted batch for the same reason (one copy of each table).
Writes that the reference aims at index ``cap`` for a scatter to drop are
masked out explicitly here.  Given a `RowJournal`, every write first
saves what it overwrites, so the caller can undo a batch that raises
part-way (the reference's batch, a pure function, then never commits).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from diskann_tpu_torch.graph import packed as packed_mod
from diskann_tpu_torch.graph import steps
from diskann_tpu_torch.graph.config import GraphConfig
from diskann_tpu_torch.graph.prune import robust_prune_steps
from diskann_tpu_torch.graph.scorers import packed_router_starts, packed_scorer
from diskann_tpu_torch.graph.search import beam_search_scored_steps, beam_search_steps
from diskann_tpu_torch.graph.state import GraphArrays, RowJournal, set_vectors, to_stored
from diskann_tpu_torch.ops.distance import pairwise_distance
from diskann_tpu_torch.ops.topk import SENTINEL, sort_with
from diskann_tpu_torch.trace import span

# rows of the [M, S] router distance matrix scored at once
_ROUTER_ROWS = 2048
# widest build pool recorded by the candidate search (W beam nodes per hop)
_POOL_CAPACITY = 512
# bytes the prune's [chunk, C, d] candidate-vector gather may take
_PRUNE_MEM_BUDGET = 1 << 30


def chunked_robust_prune(
    vectors: torch.Tensor,
    p_vecs: torch.Tensor,      # [M, d]
    cand_ids: torch.Tensor,    # [M, C]
    cand_d: torch.Tensor | None,
    self_ids: torch.Tensor,    # [M]
    config: GraphConfig,
    *,
    degree: int,
    chunk: int = 0,
):
    """RobustPrune M pools, chunked over rows only as far as the
    [chunk, C, d] candidate-vector gather demands.  Vectors of another
    dtype are lifted to float32 as they are gathered.  Returns (ids [M,
    degree], dists [M, degree], count [M])."""
    return steps.run(chunked_robust_prune_steps(**locals()))


def chunked_robust_prune_steps(
    vectors: torch.Tensor,
    p_vecs: torch.Tensor,      # [M, d]
    cand_ids: torch.Tensor,    # [M, C]
    cand_d: torch.Tensor | None,
    self_ids: torch.Tensor,    # [M]
    config: GraphConfig,
    *,
    degree: int,
    chunk: int = 0,
):
    """The stepping form of `chunked_robust_prune` (`graph/steps.py`)."""
    m, c = cand_ids.shape
    if chunk <= 0:
        per_row = c * vectors.shape[1] * 4 * 2
        chunk = max(64, min(m, _PRUNE_MEM_BUDGET // max(per_row, 1)))
    n = vectors.shape[0]
    outs = []
    for s in range(0, m, chunk):
        ci = cand_ids[s:s + chunk]
        cvec = vectors[ci.long().clamp(0, n - 1)].float()
        outs.append((yield from robust_prune_steps(
            p_vecs[s:s + chunk].float(), ci, None if cand_d is None else cand_d[s:s + chunk],
            cvec, self_ids[s:s + chunk], config, degree=degree,
        )))
    return tuple(torch.cat(parts) for parts in zip(*outs))


class InsertStats(NamedTuple):
    cmps: torch.Tensor
    hops: torch.Tensor


def insert_batch(
    state: GraphArrays,
    slot_ids: torch.Tensor,     # [M] i32 target slots (-1 for padding rows)
    new_vecs: torch.Tensor,     # [M, d] f32 (cast to the stored dtype)
    row_valid: torch.Tensor,    # [M] bool
    start_ids: torch.Tensor,    # [S] i32
    config: GraphConfig,
    packed: packed_mod.PackedState | None = None,
    *,
    backedge_src_cap: int = 64,
    router=None,                # (rc [S, dp] i8, raux [S] f32, rids [S] i32) | None
    journal: RowJournal | None = None,
):
    """Insert a batch of M new points at ``slot_ids``, in place.

    With a `PackedState`, candidate generation walks the packed int8
    layout, the prune recomputes distances from the raw vectors, and the
    packed table is kept in step.  Without one (the full build), the walk
    is the full-precision `beam_search` from ``start_ids`` (``router`` is
    ignored) and the prune takes the walk's distances.  ``journal``
    saves every row, cell and sum the batch overwrites before it does;
    ``journal.restore()`` after an exception puts the state and the
    packed table back bitwise.  Returns (state, packed, stats)."""
    return steps.run(insert_batch_steps(**locals()))


def insert_batch_steps(
    state: GraphArrays,
    slot_ids: torch.Tensor,     # [M] i32 target slots (-1 for padding rows)
    new_vecs: torch.Tensor,     # [M, d] f32 (cast to the stored dtype)
    row_valid: torch.Tensor,    # [M] bool
    start_ids: torch.Tensor,    # [S] i32
    config: GraphConfig,
    packed: packed_mod.PackedState | None = None,
    *,
    backedge_src_cap: int = 64,
    router=None,                # (rc [S, dp] i8, raux [S] f32, rids [S] i32) | None
    journal: RowJournal | None = None,
):
    """The stepping form of `insert_batch` (`graph/steps.py`): the
    candidate walk's and the prunes' flags."""
    dev = new_vecs.device
    m = new_vecs.shape[0]
    r = config.max_degree
    r_slack = state.max_degree_slack
    cap = state.capacity
    metric = config.metric
    inf = float("inf")

    new_vecs = torch.where(row_valid[:, None], new_vecs.float(), 0.0)
    # the full walk and the prune see the rows as stored (the packed
    # encode and the intra-batch distances take them unrounded, as in the
    # reference)
    stored_vecs = to_stored(new_vecs, state.vectors.dtype).float()
    new_ids = torch.where(row_valid, slot_ids, -1).to(torch.int32)
    # the pool records W beam nodes per hop: right-size it to the hop cap
    mh_eff = config.build_max_hops or config.max_hops
    pool_capacity = min(
        _POOL_CAPACITY, max(-(-mh_eff * config.beam_width // 128) * 128, 128)
    )

    # ---------------- phase 1: set elements ----------------
    set_vectors(state, slot_ids, new_vecs, row_valid=row_valid, journal=journal)
    if packed is not None:
        codes, aux = packed_mod.encode(packed, new_vecs, metric)
        packed_mod.set_self_codes(packed, new_ids, codes, aux, journal=journal)

    # ---------------- phase 2: candidate generation ----------------
    with span("insert.candidates"):
        if packed is None:
            res = yield from beam_search_steps(
                state.vectors, state.sq_norms, state.adjacency, start_ids, stored_vecs,
                metric=metric, l_search=config.l_build, beam_width=config.beam_width,
                max_hops=mh_eff, pool_capacity=pool_capacity, record_pool=True,
                query_valid=row_valid,
            )
        else:
            search_start = start_ids
            if router is not None:
                rc, raux, rids = router
                rst = torch.cat([
                    packed_router_starts(rc, raux, rids, packed.proj, packed.pscale,
                                         packed.pbias2, q, metric, config.router_starts)
                    for q in new_vecs.split(_ROUTER_ROWS)
                ])
                search_start = torch.cat(
                    [start_ids[None, :].expand(m, start_ids.shape[0]), rst], 1
                )
                search_start = torch.where(row_valid[:, None], search_start, -1)
            sdef, sdata = packed_scorer(packed, metric)
            res = yield from beam_search_scored_steps(
                sdef, sdata, state.adjacency, search_start, new_vecs,
                l_search=config.l_build, beam_width=config.beam_width,
                max_hops=mh_eff, pool_capacity=pool_capacity, record_pool=True,
                dedup="merge", query_valid=row_valid,
            )

        # intra-batch candidates
        ibc = config.intra_batch_candidates
        if ibc == "all" or (isinstance(ibc, int) and ibc > 0):
            ib_d = pairwise_distance(new_vecs, new_vecs, metric)     # [M, M]
            col_ok = row_valid[None, :] & ~torch.eye(m, dtype=torch.bool, device=dev)
            if isinstance(ibc, int):
                p = torch.arange(m, device=dev)
                col_ok = col_ok & ((p[:, None] - p[None, :]).abs() <= ibc // 2)
            ib_d = torch.where(col_ok, ib_d, inf)
            ib_ids = torch.where(col_ok, new_ids[None, :], -1)
            if m > 2 * config.max_occlusion_size:
                # only the occlusion cap's worth can survive the cut below; the
                # reference takes approx_min_k here, the port exact top-k
                kk = min(config.max_occlusion_size, m)
                ib_d, ib_pos = torch.topk(ib_d, kk, dim=1, largest=False, sorted=True)
                ib_ids = ib_ids.gather(1, ib_pos)
            cand_ids = torch.cat([res.pool_i, ib_ids], 1)
            cand_d = torch.cat([res.pool_d, ib_d], 1)
        else:
            cand_ids, cand_d = res.pool_i, res.pool_d

        # deleted nodes never become neighbours
        pool_ok = (cand_ids >= 0) & state.valid[cand_ids.long().clamp(0, cap - 1)]
        cand_ids = torch.where(pool_ok, cand_ids, -1)
        cand_d = torch.where(pool_ok, cand_d, inf)

        # truncate the pool to the occlusion cap by distance
        c_cap = min(cand_ids.shape[1], config.max_occlusion_size)
        cand_d, cand_ids = sort_with(cand_d, cand_ids)
        cand_ids = cand_ids[:, :c_cap]

        # the packed walk's distances are approximate: the prune recomputes them
        out_ids, _, out_n = yield from chunked_robust_prune_steps(
            state.vectors, stored_vecs, cand_ids,
            None if packed is not None else cand_d[:, :c_cap], new_ids, config,
            degree=r,
        )
        out_ids = torch.where(row_valid[:, None], out_ids, -1)
        out_n = torch.where(row_valid, out_n, 0)

    # ---------------- phase 3a: commit out-edges ----------------
    with span("insert.edges"):
        out_rows = torch.nn.functional.pad(out_ids, (0, r_slack - r), value=-1)
        w_live = slot_ids[row_valid].long()
        if journal is not None:
            journal.save(state.adjacency, w_live)
            journal.save(state.degrees, w_live)
        state.adjacency[w_live] = out_rows[row_valid]
        state.degrees[w_live] = out_n[row_valid]
        if packed is not None:
            packed_mod.refresh_rows(packed, state.adjacency, w_live, journal=journal)

        # ---------------- phase 3b: backedges ----------------
        tgt = out_ids[:, : min(config.max_backedges, r)] \
            if config.max_backedges is not None else out_ids
        src = new_ids[:, None].expand(tgt.shape).reshape(-1)
        tgt = tgt.reshape(-1)
        e = tgt.shape[0]
        tgt_c = tgt.long().clamp(0, cap - 1)
        pair_ok = (tgt >= 0) & state.valid[tgt_c]
        # skip sources already present in the target row
        already = (state.adjacency[tgt_c] == src[:, None]).any(1)
        pair_ok = pair_ok & ~already

        tkey = torch.where(pair_ok, tgt, SENTINEL)
        tkey_s, order = torch.sort(tkey, stable=True)
        src_s = src[order]
        ok_s = pair_ok[order]

        iota_e = torch.arange(e, device=dev)
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           tkey_s[1:] != tkey_s[:-1]])
        group_start = torch.where(first, iota_e, 0).cummax(0).values
        csum = ok_s.cumsum(0)
        csum_before = torch.where(group_start > 0,
                                  csum[(group_start - 1).clamp_min(0)], 0)
        rank = csum - 1 - csum_before                      # rank among ok in group

        tkey_c = tkey_s.long().clamp(0, cap - 1)
        slot = state.degrees[tkey_c].long() + rank
        append_ok = ok_s & (slot < r_slack) & (tkey_s != SENTINEL)

        adj_flat = state.adjacency.view(-1)
        cells = tkey_c[append_ok] * r_slack + slot[append_ok]
        t_app = tkey_c[append_ok]
        if journal is not None:
            journal.save(adj_flat, cells)
            journal.save(state.degrees, t_app)
        adj_flat[cells] = src_s[append_ok]
        state.degrees.index_add_(0, t_app, torch.ones_like(t_app, dtype=torch.int32))
        if packed is not None:
            packed_mod.append_edges(packed, tkey_s, slot, src_s, append_ok, journal=journal)

        # ---------------- phase 3c: re-prune overfull targets ----------------
        overflow = ok_s & (slot >= r_slack)
        group_has_of = torch.zeros(e, dtype=torch.int32, device=dev).scatter_reduce(
            0, group_start, overflow.to(torch.int32), reduce="amax"
        ) > 0
        sel_first = first & group_has_of & (tkey_s != SENTINEL)

        # group starts of overfull targets, the first min(m, e) of them (the
        # reference's fixed shape); only those rows are re-pruned
        pick = torch.nonzero(sel_first).squeeze(1)[: min(m, e)]
        t_u = tkey_s[pick]
        gpos = pick[:, None] + torch.arange(backedge_src_cap, device=dev)[None, :]
        gpos_c = gpos.clamp_max(e - 1)
        g_ok = (gpos < e) & (tkey_s[gpos_c] == t_u[:, None]) & ok_s[gpos_c]
        g_src = torch.where(g_ok, src_s[gpos_c], -1)

        if pick.numel():
            t_l = t_u.long()
            pool_ids = torch.cat([state.adjacency[t_l], g_src], 1)  # [U, R_slack+K]
            rp_ids, _, rp_n = yield from chunked_robust_prune_steps(
                state.vectors, state.vectors[t_l], pool_ids, None, t_u, config,
                degree=r,
            )
            if journal is not None:
                journal.save(state.adjacency, t_l)
                journal.save(state.degrees, t_l)
            state.adjacency[t_l] = torch.nn.functional.pad(
                rp_ids, (0, r_slack - r), value=-1
            )
            state.degrees[t_l] = rp_n
            if packed is not None:
                packed_mod.refresh_rows(packed, state.adjacency, t_l, journal=journal)

        return state, packed, InsertStats(cmps=res.cmps, hops=res.hops)
