"""Frontier-batched greedy beam search (PyTorch port of
`diskann_tpu/graph/search.py`).

Keep a distance-sorted best-list of size L per query; each hop expands the
``beam_width`` closest unexpanded entries of every query in the batch at
once, scores their neighbours, and merges; stop when no query has an
unexpanded entry or after ``max_hops`` hops.  The hop loop is a Python loop
that checks convergence once per hop: `beam_search_scored_steps` yields
the flag (`graph/steps.py`), `beam_search_scored` answers it in the
calling thread.

Three dedup modes:

- ``"ring"``: candidates already in the best-list, in a per-query ring of
  recently scored ids, or repeated within the hop are dropped before they
  are scored (the reference's visited set, exact up to the ring's age);
- ``"list"`` (packed search): the best-list and the hop only; a node that
  fell off the list may be scored again (extra cmps, identical results).
  Through the packed scorer, the plain list walk (no filter, reserve,
  quota, pool or resume) runs each hop as two kernels, K1 then K3
  (`ScorerDef.list_hop`, `ops/kernels/hop_merge.py`), with the results of
  the loop below;
- ``"merge"`` (build): duplicates are dropped inside the merge sort — the
  same id always carries the same distance, so sorting by (distance, id)
  lands its copies side by side.

Filters (``accept_fn``): the inline beta filter keeps a separate list of
matching nodes at their true distances and shrinks the navigation
distances of matching nodes by ``filter_beta``; ``filter_mode="multihop"``
admits only matching nodes to the navigation list and tunnels through the
closest rejected neighbours with a second, accept-only expansion.

``reserve`` keeps extra list slots past the active window of
``l_search``: frontier selection and termination see only the window, and
paged search drains results so the reserve slides in.  A diversity quota
(``diverse_attrs``, ``diverse_l``) evicts, after every merge, the entries
whose rank within their attribute reaches ``diverse_l``.  ``merge_trunc``
cuts each hop's candidates to the list width before the merge.

Every sort is stable, which reproduces the reference's tie order and
therefore its ids and ``cmps`` exactly for the same scorer inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from diskann_tpu_torch.graph import steps
from diskann_tpu_torch.graph.scorers import ScorerDef, full_precision_scorer
from diskann_tpu_torch.ops.distance import Metric
from diskann_tpu_torch.ops.kernels import hop_merge
from diskann_tpu_torch.ops.topk import (
    SENTINEL, grouped_ranks, isin_rows, mask_duplicates_sorted, sort_lex,
    sort_with,
)

_INF = float("inf")


class SearchResult(NamedTuple):
    dists: torch.Tensor    # [B, L] f32 ascending
    ids: torch.Tensor      # [B, L] i32 (-1 pad)
    cmps: torch.Tensor     # [B] i32 distance computations
    hops: torch.Tensor     # [B] i32 nodes expanded
    pool_d: torch.Tensor   # [B, P] expanded pool distances (build)
    pool_i: torch.Tensor   # [B, P]
    pool_n: torch.Tensor   # [B]
    match_d: torch.Tensor  # [B, Lm] filter-matching results (true distances)
    match_i: torch.Tensor  # [B, Lm]


class ResumeState(NamedTuple):
    """Search scratch to pass back via ``resume_state`` and continue."""

    best_d: torch.Tensor   # [B, L]
    best_i: torch.Tensor   # [B, L]
    best_exp: torch.Tensor  # [B, L]
    ring: torch.Tensor     # [B, H]
    cmps: torch.Tensor     # [B]
    hops: torch.Tensor     # [B]
    match_d: torch.Tensor  # [B, Lm] filtered matched list ([B, 1] dummy)
    match_i: torch.Tensor  # [B, Lm]


def _beta_bias(d, accepted, beta: float):
    """Bias navigation distances toward filter matches: positive distances
    shrink by *beta, negative (inner-product) ones grow by /beta."""
    if beta == 1.0:
        return d
    biased = torch.where(d >= 0, d * beta, d / beta)
    return torch.where(accepted, biased, d)


def _match_merge(md, mi, lm: int):
    """Merge candidate (d, id) columns into the matched-only list, dropping
    repeated ids: one id always carries the same true distance, so sorting
    by (d, id) lands its copies side by side."""
    md, mi = sort_lex(md, mi)
    prev = torch.nn.functional.pad(mi[:, :-1], (1, 0), value=-2)
    dup = (mi == prev) & (mi >= 0)
    md, mi = sort_with(torch.where(dup, _INF, md), torch.where(dup, -1, mi))
    return md[:, :lm], mi[:, :lm]


def search_geometry(*, l_search: int, reserve: int, beam_width: int, r: int,
                    s: int, expand_r: int | None = None,
                    history_capacity: int = 0, dedup: str = "ring"):
    """Scratch shapes of a `beam_search_scored` call: (list width L,
    candidates per hop C, ring width H)."""
    l = l_search + reserve
    c = beam_width * (expand_r if expand_r is not None else r)
    want_h = history_capacity if history_capacity > 0 else max(2048, 6 * l)
    ring_hops = max(2, -(-max(want_h - s, c) // c))
    if dedup in ("list", "merge"):
        ring_hops = 1  # minimal stub; the ring compare is skipped
    return l, c, s + ring_hops * c


def grow_resume_state(st: ResumeState, l_total: int,
                      ring_width: int) -> ResumeState:
    """Pad a ResumeState to a larger list and ring width, so a search can
    resume with a bigger L window (AdaptiveL) instead of restarting.  New
    list slots are empty (inf / -1 / expanded), appended at the sorted
    tail; the ring pads with -1 (its membership test scans all of it)."""
    l_old = st.best_d.shape[1]
    dl = l_total - l_old
    dh = ring_width - st.ring.shape[1]
    if dl < 0 or dh < 0:
        raise ValueError("resume states only grow")
    if dl == 0 and dh == 0:
        return st
    pad = torch.nn.functional.pad
    has_match = st.match_d.shape[1] == l_old  # filtered search: Lm == L
    return ResumeState(
        best_d=pad(st.best_d, (0, dl), value=_INF),
        best_i=pad(st.best_i, (0, dl), value=-1),
        best_exp=pad(st.best_exp, (0, dl), value=1),
        ring=pad(st.ring, (0, dh), value=-1),
        cmps=st.cmps,
        hops=st.hops,
        match_d=pad(st.match_d, (0, dl), value=_INF) if has_match else st.match_d,
        match_i=pad(st.match_i, (0, dl), value=-1) if has_match else st.match_i,
    )


def beam_search_scored(
    scorer_def: ScorerDef,
    scorer_data,
    adjacency: torch.Tensor,      # [N, R] i32, -1 padded
    start_ids: torch.Tensor,      # [S] or [B, S] i32
    queries: torch.Tensor,        # [B, d]
    *,
    l_search: int,
    beam_width: int = 1,
    max_hops: int = 512,
    history_capacity: int = 0,
    pool_capacity: int = 1,
    record_pool: bool = False,
    dedup: str = "ring",
    accept_fn=None,               # (accept_data, ids, valid) -> bool mask
    accept_data=None,
    filter_beta: float = 1.0,
    filter_mode: str = "inline",  # "inline" | "multihop"
    query_valid: torch.Tensor | None = None,   # [B] bool — padded rows
    expand_r: int | None = None,  # scorer.expand slots per node if != R
    resume_state: ResumeState | None = None,
    return_state: bool = False,
    reserve: int = 0,
    reseed_ring: bool = False,
    diverse_attrs: torch.Tensor | None = None,   # [cap] i32 attribute per point
    diverse_l: int = 0,           # per-attribute quota in the navigation list
    merge_trunc: bool = False,    # cut candidates to the list width
):
    """Batched greedy beam search with a pluggable scorer.  Returns a
    `SearchResult`, and with ``return_state`` also the final
    `ResumeState`."""
    return steps.run(beam_search_scored_steps(**locals()))


def beam_search_scored_steps(
    scorer_def: ScorerDef,
    scorer_data,
    adjacency: torch.Tensor,      # [N, R] i32, -1 padded
    start_ids: torch.Tensor,      # [S] or [B, S] i32
    queries: torch.Tensor,        # [B, d]
    *,
    l_search: int,
    beam_width: int = 1,
    max_hops: int = 512,
    history_capacity: int = 0,
    pool_capacity: int = 1,
    record_pool: bool = False,
    dedup: str = "ring",
    accept_fn=None,               # (accept_data, ids, valid) -> bool mask
    accept_data=None,
    filter_beta: float = 1.0,
    filter_mode: str = "inline",  # "inline" | "multihop"
    query_valid: torch.Tensor | None = None,   # [B] bool — padded rows
    expand_r: int | None = None,  # scorer.expand slots per node if != R
    resume_state: ResumeState | None = None,
    return_state: bool = False,
    reserve: int = 0,
    reseed_ring: bool = False,
    diverse_attrs: torch.Tensor | None = None,   # [cap] i32 attribute per point
    diverse_l: int = 0,           # per-attribute quota in the navigation list
    merge_trunc: bool = False,    # cut candidates to the list width
):
    """The stepping form of `beam_search_scored` (`graph/steps.py`): yields
    each hop's "any entry left unexpanded" flag and ends the walk on a
    False answer; returns what `beam_search_scored` returns."""
    if dedup not in ("ring", "list", "merge"):
        raise ValueError(f"unknown dedup {dedup!r}")
    if filter_mode not in ("inline", "multihop"):
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    if dedup == "merge" and (scorer_def.expand is None or accept_fn is not None):
        raise ValueError("dedup='merge' needs an expand scorer and no filter")

    dev = queries.device
    b = queries.shape[0]
    n, r = adjacency.shape
    s = start_ids.shape[-1]
    w = beam_width
    l, c, h = search_geometry(
        l_search=l_search, reserve=reserve, beam_width=w, r=r, s=s,
        expand_r=expand_r, history_capacity=history_capacity, dedup=dedup,
    )
    ring_hops = (h - s) // c
    p = pool_capacity if record_pool else 1
    filtered = accept_fn is not None
    multihop = filtered and filter_mode == "multihop"

    q_ctx = scorer_def.prep(scorer_data, queries)

    # ---- init: score the start points ----
    sid = (start_ids.expand(b, s) if start_ids.dim() == 1 else start_ids)
    sid = sid.to(device=dev, dtype=torch.int32)
    svalid = sid >= 0
    sd = scorer_def.score(scorer_data, q_ctx, sid, svalid)

    lm = l if filtered else 1
    if filtered:
        # the matched-only result list, seeded from the accepted start
        # points (which may repeat: router starts can hit one node twice)
        sacc = accept_fn(accept_data, sid, svalid)
        mpad = max(l - s, 0)
        match_d, match_i = _match_merge(
            torch.nn.functional.pad(torch.where(sacc, sd, _INF), (0, mpad),
                                    value=_INF),
            torch.nn.functional.pad(torch.where(sacc, sid, -1), (0, mpad),
                                    value=-1),
            lm,
        )
        sd = _beta_bias(sd, sacc, filter_beta)
    else:
        match_d = torch.full((b, lm), _INF, device=dev)
        match_i = torch.full((b, lm), -1, dtype=torch.int32, device=dev)

    pad = max(l - s, 0)
    best_d, best_i = sort_with(
        torch.nn.functional.pad(sd, (0, pad), value=_INF),
        torch.nn.functional.pad(sid, (0, pad), value=-1),
    )
    best_d, best_i = best_d[:, :l], best_i[:, :l]
    best_e = (best_i < 0).to(torch.int32)          # expanded flags

    ring = torch.full((b, h), -1, dtype=torch.int32, device=dev)
    ring[:, :s] = torch.where(svalid, sid, -1)

    if query_valid is not None:
        # converged-from-the-start rows: mark everything expanded
        best_e = torch.where(query_valid[:, None], best_e, 1)

    cmps = svalid.sum(1, dtype=torch.int32)
    hops = torch.zeros(b, dtype=torch.int32, device=dev)
    if resume_state is not None:
        if resume_state.ring.shape[1] != h:
            raise ValueError("resume with the ring width of this call "
                             "(grow_resume_state)")
        best_d, best_i = resume_state.best_d, resume_state.best_i
        best_e, ring = resume_state.best_exp, resume_state.ring.clone()
        cmps, hops = resume_state.cmps, resume_state.hops
        if filtered and resume_state.match_d.shape[1] == lm:
            # the matched list carries over (it already holds the starts)
            match_d, match_i = resume_state.match_d, resume_state.match_i
        if reseed_ring:
            # A converged pass has every list entry expanded, so a grown
            # window alone gives no frontier.  The ring holds every id the
            # pass scored, including those that fell off its smaller list:
            # re-score them and merge them as unexpanded entries.
            rid = torch.sort(torch.where(ring >= 0, ring, SENTINEL), dim=1).values
            rfresh = ((rid != SENTINEL) & ~mask_duplicates_sorted(rid)
                      & ~isin_rows(rid, best_i))
            rd = scorer_def.score(scorer_data, q_ctx, rid, rfresh)
            rids = torch.where(rfresh, rid, -1)
            cmps = cmps + rfresh.sum(1, dtype=torch.int32)
            if filtered:
                racc = accept_fn(accept_data, rid, rfresh) & rfresh
                match_d, match_i = _match_merge(
                    torch.cat([match_d, torch.where(racc, rd, _INF)], 1),
                    torch.cat([match_i, torch.where(racc, rids, -1)], 1),
                    lm,
                )
                if multihop:
                    # multihop navigation admits accepted nodes only
                    rd = torch.where(racc, rd, _INF)
                    rids = torch.where(racc, rids, -1)
                else:
                    rd = _beta_bias(rd, racc, filter_beta)
            md, mi, me = sort_with(
                torch.cat([best_d, rd], 1), torch.cat([best_i, rids], 1),
                torch.cat([best_e, (rids < 0).to(torch.int32)], 1),
            )
            best_d, best_i, best_e = md[:, :l], mi[:, :l], me[:, :l]

    # ---- in-traversal diversity quota: after every merge, evict entries
    # whose distance rank within their attribute is >= diverse_l, before
    # the cut to L, so their slots go to other attributes ----
    use_quota = diverse_attrs is not None and diverse_l > 0
    if use_quota:
        acap = diverse_attrs.shape[0]

        def quota_evict(md, key):
            """md / key: [B, M] distance-sorted list, key = id*2 | expanded
            (-1 empty).  Returns the list re-sorted after the eviction."""
            kid = key >> 1
            a = torch.where(kid >= 0, diverse_attrs[kid.clamp(0, acap - 1).long()], -1)
            evict = (kid >= 0) & (grouped_ranks(a) >= diverse_l)
            return sort_with(torch.where(evict, _INF, md), torch.where(evict, -1, key))

        best_d, k0 = quota_evict(
            best_d, torch.where(best_i >= 0, best_i * 2 + best_e, -1))
        best_i, best_e = k0 >> 1, k0 & 1

    pool_d = torch.full((b, p), _INF, device=dev)
    pool_i = torch.full((b, p), -1, dtype=torch.int32, device=dev)
    pool_n = torch.zeros(b, dtype=torch.int32, device=dev)

    # the plain list walk through a scorer that does whole hops (the
    # packed one: K1 and K3, `ops/kernels/hop_merge.py`): the lists, cmps
    # and hops of the loop below, one flag a hop
    list_hop = None
    if (dedup == "list" and scorer_def.list_hop is not None and not filtered
            and not reserve and not use_quota and not record_pool
            and resume_state is None and not return_state):
        list_hop = scorer_def.list_hop(scorer_data, q_ctx, min(w, l), l)
    if list_hop is not None:
        st, flag = hop_merge.start(best_d, best_i, best_e, cmps, hops, w)
        for it in range(max_hops):
            if not (yield flag):
                break
            list_hop(st, it)
            flag = st.flags[it % 2]
        return SearchResult(
            dists=st.best_d, ids=st.best_i, cmps=st.cmps, hops=st.hops,
            pool_d=pool_d, pool_i=pool_i, pool_n=pool_n,
            match_d=match_d, match_i=match_i,
        )

    # with a reserve, frontier and termination see the first l_search slots only
    active = (torch.arange(l, device=dev) < l_search).expand(b, l) if reserve else None

    for it in range(max_hops):
        # ---- 1. frontier: the W closest unexpanded entries per row ----
        flag, sel_pos, beam_ids, next_e = hop_merge.frontier(best_i, best_e, w, active)
        if not (yield flag):
            break
        best_e = next_e
        beam_valid = sel_pos < l
        beam_d = best_d.gather(1, sel_pos.clamp_max(l - 1))
        n_exp = beam_valid.sum(1, dtype=torch.int32)

        # ---- record the expanded pool (build-time prune candidates) ----
        if record_pool and (it + 1) * w <= p:
            off = it * w
            pool_d[:, off:off + w] = torch.where(beam_valid, beam_d, _INF)
            pool_i[:, off:off + w] = beam_ids
        if record_pool:
            pool_n += n_exp

        if dedup == "merge":
            ci, cd = scorer_def.expand(scorer_data, q_ctx, beam_ids, beam_valid)
            # sort by (d, id*4 | is_new*2 | expanded): an id's copies land
            # adjacent with the old entry first
            md = torch.cat([best_d, cd], 1)
            key = torch.cat([best_i * 4 + best_e, ci * 4 + 2], 1)
            md, key = sort_lex(md, key)
            mi = key >> 2
            dup = mask_duplicates_sorted(mi) & (mi >= 0)
            fresh_n = (((key & 2) == 2) & ~dup & (mi >= 0)).sum(1, dtype=torch.int32)
            md = torch.where(dup, _INF, md)
            key2 = torch.where(dup, -1, mi * 2 + (key & 1))
            md, key2 = sort_with(md, key2)
            if use_quota:
                md, key2 = quota_evict(md, key2)
            best_d = md[:, :l]
            best_i = key2[:, :l] >> 1
            best_e = key2[:, :l] & 1
            cmps = cmps + fresh_n
            hops = hops + n_exp
            continue

        # ---- 2. expand the beam: every neighbour, sorted by id ----
        if scorer_def.expand is not None:
            # the packed layout scores every neighbour in the same pass
            ci, cd = scorer_def.expand(scorer_data, q_ctx, beam_ids, beam_valid)
            cand = torch.where(ci >= 0, ci, SENTINEL)
            cand, cand_d = sort_with(cand, cd)
        else:
            nbrs = adjacency[beam_ids.clamp(0, n - 1).long()]       # [B, W, R]
            nbrs = torch.where(beam_valid[:, :, None], nbrs, -1)
            cand = nbrs.reshape(b, w * r)
            cand = torch.sort(torch.where(cand >= 0, cand, SENTINEL), dim=1).values
            cand_d = None

        # ---- 3. dedup: within the hop, against the list and the ring ----
        fresh = ((cand != SENTINEL) & ~mask_duplicates_sorted(cand)
                 & ~isin_rows(cand, best_i))
        if dedup == "ring":
            fresh &= ~isin_rows(cand, ring)
            # this hop's segment of the ring: one contiguous write
            seg = s + (it % ring_hops) * c
            ring[:, seg:seg + c] = torch.where(fresh, cand, -1)

        # ---- 4. score the fresh candidates ----
        if cand_d is None:
            cd = scorer_def.score(scorer_data, q_ctx, cand, fresh)
        else:
            cd = torch.where(fresh, cand_d, _INF)
        cand_ids = torch.where(fresh, cand, -1)
        cmps = cmps + fresh.sum(1, dtype=torch.int32)
        hops = hops + n_exp

        # ---- 4b. filter: matched list, beta bias or two-hop tunnel ----
        extra_d = extra_k = None
        if filtered:
            acc = accept_fn(accept_data, cand, fresh) & fresh
            match_d, match_i = _match_merge(
                torch.cat([match_d, torch.where(acc, cd, _INF)], 1),
                torch.cat([match_i, torch.where(acc, cand_ids, -1)], 1),
                lm,
            )
            if multihop:
                # the closest max(R/2, 1) rejected neighbours get a second,
                # accept-only expansion; R is the adjacency width
                w2 = max(r // 2, 1)
                rd2, ri2 = sort_with(torch.where(fresh & ~acc, cd, _INF), cand)
                hop2 = torch.where(torch.isfinite(rd2[:, :w2]), ri2[:, :w2], -1)
                nb2 = adjacency[hop2.clamp(0, n - 1).long()]
                nb2 = torch.where((hop2 >= 0)[:, :, None], nb2, -1)
                cand2 = torch.where(nb2 >= 0, nb2, SENTINEL).reshape(b, w2 * r)
                cand2 = torch.sort(cand2, dim=1).values
                fresh2 = ((cand2 != SENTINEL) & ~mask_duplicates_sorted(cand2)
                          & ~isin_rows(cand2, best_i) & ~isin_rows(cand2, cand))
                cd2 = scorer_def.score(scorer_data, q_ctx, cand2, fresh2)
                acc2 = accept_fn(accept_data, cand2, fresh2) & fresh2
                extra_d = torch.where(acc2, cd2, _INF)
                extra_i = torch.where(acc2, cand2, -1)
                extra_k = torch.where(acc2, cand2 * 2, -1)
                match_d, match_i = _match_merge(
                    torch.cat([match_d, extra_d], 1),
                    torch.cat([match_i, extra_i], 1), lm,
                )
                cmps = cmps + fresh2.sum(1, dtype=torch.int32)
                hops = hops + (hop2 >= 0).sum(1, dtype=torch.int32)
                # the navigation list takes accepted one-hop candidates only
                cd = torch.where(acc, cd, _INF)
                cand_ids = torch.where(acc, cand_ids, -1)
            else:
                cd = _beta_bias(cd, acc, filter_beta)

        # ---- 4c. cut the candidates to the l closest: no more can enter
        # the list.  A stable sort keeps the lower column first on equal
        # distances, as the reference's top_k ----
        if merge_trunc and extra_d is None and c > l:
            cd, order = torch.sort(cd, dim=1, stable=True)
            cd, cand_ids = cd[:, :l], cand_ids.gather(1, order[:, :l])

        # ---- 5. merge into the best lists: (id, expanded) in one word ----
        md = [best_d, cd]
        key = [best_i * 2 + best_e, torch.where(cand_ids >= 0, cand_ids * 2, -1)]
        if extra_d is not None:
            md.append(extra_d)
            key.append(extra_k)
        md, key = sort_with(torch.cat(md, 1), torch.cat(key, 1))
        if use_quota:
            md, key = quota_evict(md, key)
        best_d = md[:, :l]
        best_i = key[:, :l] >> 1
        best_e = key[:, :l] & 1

    out = SearchResult(
        dists=best_d, ids=best_i, cmps=cmps, hops=hops,
        pool_d=pool_d, pool_i=pool_i, pool_n=pool_n,
        match_d=match_d, match_i=match_i,
    )
    if return_state:
        return out, ResumeState(
            best_d=best_d, best_i=best_i, best_exp=best_e, ring=ring,
            cmps=cmps, hops=hops, match_d=match_d, match_i=match_i,
        )
    return out


def beam_search(vectors, vec_sq_norms, adjacency, start_ids, queries, *,
                metric: Metric, l_search: int, beam_width: int = 1,
                max_hops: int = 512, history_capacity: int = 0,
                pool_capacity: int = 1, record_pool: bool = False,
                dedup: str = "ring", query_valid=None) -> SearchResult:
    """Full-precision beam search (the in-memory configuration)."""
    return steps.run(beam_search_steps(**locals()))


def beam_search_steps(vectors, vec_sq_norms, adjacency, start_ids, queries, *,
                      metric: Metric, l_search: int, beam_width: int = 1,
                      max_hops: int = 512, history_capacity: int = 0,
                      pool_capacity: int = 1, record_pool: bool = False,
                      dedup: str = "ring", query_valid=None):
    """The stepping form of `beam_search` (`graph/steps.py`)."""
    sdef, sdata = full_precision_scorer(vectors, vec_sq_norms, metric)
    return (yield from beam_search_scored_steps(
        sdef, sdata, adjacency, start_ids, queries,
        l_search=l_search, beam_width=beam_width, max_hops=max_hops,
        history_capacity=history_capacity, pool_capacity=pool_capacity,
        record_pool=record_pool, dedup=dedup, query_valid=query_valid,
    ))
