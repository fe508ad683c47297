"""Search modes beside k-NN: range, paged and diversity-aware search, and the
determinant-diversity rerank (PyTorch port of `diskann_tpu/graph/modes.py`).

- Range search: L-doubling rounds until the furthest retrieved point lies
  outside the radius.  The full-precision walk resumes one search scratch
  across rounds (grown list and ring, frontier re-seeded from the ring);
  other modes search again at each L.
- Paged search: one query's result stream in pages.  The scratch persists:
  each page drains what it returns from the best list and resumes the hop
  loop, with reserve slots holding the candidates past the window.
- Diverse search: top-k with at most ``max_per_attribute`` results per
  attribute value, greedily in distance order (an entry is kept iff its
  rank among same-attribute candidates is below the quota), either as a
  post-process or as a quota inside the walk.
- Determinant rerank: over-fetch L candidates, then greedily maximize the
  determinant of the relevance-scaled candidates' Gram matrix by pivoted
  Gram-Schmidt.

Every function takes a port `GraphIndex` and runs on its device; results
come back as numpy arrays, as from `GraphIndex.search`.
"""

from __future__ import annotations

import numpy as np
import torch

from diskann_tpu_torch.graph.index import SearchStats, _filter_deleted
from diskann_tpu_torch.graph.search import (
    ResumeState, beam_search_scored, grow_resume_state, search_geometry,
)
from diskann_tpu_torch.ops.topk import grouped_ranks, sort_with

_INF = float("inf")
_INT32_MAX = 2**31 - 1


def range_search(index, queries, radius: float, *, l_init: int | None = None,
                 l_max: int = 8192, mode: str = "full",
                 return_complete: bool = False, resume: bool = True):
    """All ids within ``radius`` of each query: a list of int64 id arrays,
    and with ``return_complete`` a [B] bool array marking the queries
    whose boundary was found (the furthest retrieved point lies outside
    the radius, or the graph ran out of points); a query still at the
    ``l_max`` window is incomplete.

    mode="full" with ``resume`` grows and resumes one scratch per round;
    any other mode (or ``resume=False``) runs a fresh search per round, and
    so does an index without the full vectors on the device: a
    `TieredIndex` (whose search reranks each round's candidates exactly
    from host rows, and reads mode "full" as its own traversal codes) or a
    graph whose vectors were dropped."""
    graph = hasattr(index, "_scorer_for_mode")
    q = index._queries(queries) if graph else queries
    l = l_init or max(32, index.config.l_build)
    if resume and mode == "full" and graph and not index._hbm_vectors_dropped:
        d, ids = _range_rounds_resume(index, q, radius, l, l_max)
    else:
        d, ids = _range_rounds_restart(index, q, radius, l, l_max, mode)
    inside = (ids >= 0) & (d <= radius)
    results = [row[ok].astype(np.int64) for row, ok in zip(ids, inside)]
    complete = ~(ids >= 0).all(1) | (d[:, -1] > radius)
    if return_complete:
        return results, complete
    return results


def _range_rounds_restart(index, q, radius, l, l_max, mode):
    """L-doubling rounds, each a fresh search."""
    while True:
        d, ids, _ = index.search(q, k=l, l_search=l, mode=mode)
        done = ~(ids >= 0).all(1) | (d[:, -1] > radius)
        if done.all() or l >= l_max:
            return d, ids
        l = min(2 * l, l_max)


def _range_rounds_resume(index, q, radius, l, l_max):
    """L-doubling rounds over one persistent scratch: each round grows the
    window (`grow_resume_state`) and resumes, so expanded nodes are never
    walked again."""
    sdef, sdata, expand_r = index._scorer_for_mode("full")
    start = index._start()
    cfg = index.config
    r = index.state.adjacency.shape[1]
    valid = index.state.valid
    st = None
    while True:
        hist = cfg.history_capacity(l)
        l_tot, _, h = search_geometry(l_search=l, reserve=0, beam_width=cfg.beam_width,
                                      r=r, s=start.shape[-1], history_capacity=hist)
        if st is not None:
            st = grow_resume_state(st, l_tot, h)
        res, st = beam_search_scored(
            sdef, sdata, index.state.adjacency, start, q,
            l_search=l, beam_width=cfg.beam_width, max_hops=cfg.max_hops,
            history_capacity=hist, expand_r=expand_r,
            resume_state=st, return_state=True, reseed_ring=st is not None,
        )
        ids = res.ids[:, :l]
        live = (ids >= 0) & valid[ids.long().clamp(0, valid.shape[0] - 1)]
        d, ids = sort_with(torch.where(live, res.dists[:, :l], _INF),
                           torch.where(live, ids, -1))
        d, ids = d.cpu().numpy(), ids.cpu().numpy()
        done = ~(ids >= 0).all(1) | (d[:, -1] > radius)
        if done.all() or l >= l_max:
            return d, ids
        l = min(2 * l, l_max)


def _drain_state(state: ResumeState, drain_ids: torch.Tensor) -> ResumeState:
    """Remove ``drain_ids`` from the best list: drained slots become (inf,
    -1, expanded) and one sort pushes them out, freeing room for farther
    candidates on the next resume."""
    hit = torch.isin(state.best_i, drain_ids) & (state.best_i >= 0)
    bd, bi, be = sort_with(torch.where(hit, _INF, state.best_d),
                           torch.where(hit, -1, state.best_i),
                           torch.where(hit, 1, state.best_exp))
    return state._replace(best_d=bd, best_i=bi, best_exp=be)


class PagedSearch:
    """Resumable pagination over one query's result stream: the search
    scratch persists; each page drains what it returns and resumes the hop
    loop, so page N costs only the incremental expansion.  Pages do not
    overlap, and each is distance-sorted (across pages order is not
    guaranteed, as in the reference)."""

    def __init__(self, index, query, *, l_search: int | None = None,
                 mode: str = "full", page_l_slack: int = 16,
                 reserve: int | None = None):
        self.index = index
        self.query = index._queries(query).reshape(1, -1)
        self.mode = mode
        self.l = l_search or max(page_l_slack, index.config.l_build)
        # reserve slots hold scored candidates past the window; draining
        # slides them into it, so later pages keep streaming
        self.reserve = 3 * self.l if reserve is None else reserve
        self.exhausted = False
        self.state: ResumeState | None = None
        self._served: set[int] = set()

    def _run(self, resume):
        idx = self.index
        sdef, sdata, expand_r = idx._scorer_for_mode(self.mode)
        res, self.state = beam_search_scored(
            sdef, sdata, idx.state.adjacency, idx._start(), self.query,
            l_search=self.l, beam_width=idx.config.beam_width,
            max_hops=idx.config.max_hops,
            history_capacity=idx.config.history_capacity(self.l),
            expand_r=expand_r, resume_state=resume, return_state=True,
            reserve=self.reserve,
        )
        return res

    def next_page(self, k: int):
        """The next up to k results: (dists float32, ids int64); empty
        once the stream is exhausted."""
        empty = (np.empty(0, np.float32), np.empty(0, np.int64))
        if self.exhausted:
            return empty
        res = self._run(self.state)
        ids = res.ids[0].cpu().numpy()
        dists = res.dists[0].cpu().numpy()
        valid = self.index.state.valid.cpu().numpy()
        ok = (ids >= 0) & valid[np.clip(ids, 0, len(valid) - 1)]
        # the drain keeps pages apart; _served guards a drained id that
        # aged out of the ring and was found again
        ok &= ~np.isin(ids, np.fromiter(self._served, np.int64, len(self._served)))
        take = np.nonzero(ok)[0][:k]
        if len(take) == 0:
            self.exhausted = True
            return empty
        page_i, page_d = ids[take], dists[take]
        self._served.update(int(i) for i in page_i)
        self.state = _drain_state(
            self.state, torch.as_tensor(page_i, device=res.ids.device))
        return page_d.astype(np.float32), page_i.astype(np.int64)


def diverse_topk_device(dists: torch.Tensor, ids: torch.Tensor,
                        attrs: torch.Tensor, k: int, max_per_attribute: int):
    """Greedy diversity-constrained top-k of distance-sorted rows: a
    candidate is admitted iff fewer than ``max_per_attribute`` closer
    candidates share its attribute.  Ranks within equal-attribute groups
    (`grouped_ranks`), then the keepers compacted left.  Returns (dists
    [B, k], ids [B, k]), -1 / inf padded."""
    b = ids.shape[0]
    cap = attrs.shape[0]
    valid = ids >= 0
    a = torch.where(valid, attrs[ids.long().clamp(0, cap - 1)], _INT32_MAX)
    keep = valid & (grouped_ranks(a) < max_per_attribute)
    slot = keep.cumsum(1) - 1
    slot = torch.where(keep & (slot < k), slot, k)   # column k is dropped
    out_d = torch.full((b, k + 1), _INF, dtype=dists.dtype, device=dists.device)
    out_i = torch.full((b, k + 1), -1, dtype=ids.dtype, device=ids.device)
    out_d.scatter_(1, slot, dists)
    out_i.scatter_(1, slot, ids)
    return out_d[:, :k], out_i[:, :k]


def diverse_topk(dists, ids, attrs, k: int, max_per_attribute: int):
    """`diverse_topk_device` on host arrays (numpy in, numpy out; ids as
    int64), computed on the CPU."""
    od, oi = diverse_topk_device(
        torch.as_tensor(np.asarray(dists, np.float32)),
        torch.as_tensor(np.asarray(ids, np.int32)),
        torch.as_tensor(np.asarray(attrs, np.int32)),
        k, max_per_attribute,
    )
    return od.numpy(), oi.numpy().astype(np.int64)


def determinant_diversity_device(cand_vecs: torch.Tensor, cand_d: torch.Tensor,
                                 valid: torch.Tensor, k: int,
                                 power: float = 1.0, eta: float = 0.0):
    """Batched determinant-diversity selection: greedily maximize
    det(X_S X_S^T + eta I) over size-k subsets of relevance-scaled
    candidates by pivoted Gram-Schmidt.  Each step takes the residual of
    largest norm and deflates the rest against it.  Returns positions
    [B, k] into the candidate axis (-1 = none), in selection order."""
    b, c, _ = cand_vecs.shape
    eps = float(np.finfo(np.float32).eps)
    dmax = torch.where(valid, cand_d, -_INF).amax(1, keepdim=True)
    dmin = torch.where(valid, cand_d, _INF).amin(1, keepdim=True)
    span = (dmax - dmin).clamp_min(eps)
    sim = ((dmax - cand_d) / span).clamp_min(0.0) + eps
    inv_sqrt_eta = float(np.float32(1.0 / np.sqrt(eta))) if eta > 0.0 else 1.0
    alpha = sim ** power * inv_sqrt_eta
    r = torch.where(valid[:, :, None], cand_vecs.float() * alpha[:, :, None], 0.0)
    norms = (r * r).sum(-1)
    avail = valid.clone()
    rows = torch.arange(b, device=r.device)
    cols = torch.arange(c, device=r.device)
    selected = torch.full((b, k), -1, dtype=torch.int32, device=r.device)
    for t in range(min(k, c)):
        masked = torch.where(avail, norms, -_INF)
        piv = masked.argmax(1)
        has = masked[rows, piv] > -_INF
        selected[:, t] = torch.where(has, piv, -1)
        avail &= ~((cols[None, :] == piv[:, None]) & has[:, None])
        rstar = r[rows, piv]                                    # [B, d]
        bn = norms[rows, piv]
        inv = torch.where(bn > 0.0, 1.0 / bn, 0.0)   # a zero pivot deflates nothing
        proj = (r @ rstar[:, :, None]).squeeze(-1) * inv[:, None]
        proj = torch.where(avail, proj, 0.0)
        r = r - proj[:, :, None] * rstar[:, None, :]
        norms = (norms - proj * proj * bn[:, None]).clamp_min(0.0)
    return selected


def determinant_rerank(index, queries, k: int = 10, *, l_search: int | None = None,
                       power: float = 1.0, eta: float = 0.0, mode: str = "full"):
    """Diversity-promoting rerank: over-fetch L candidates by
    ``index.search``, then select k by `determinant_diversity_device`.
    Returns (dists, ids, stats), ids in selection order."""
    l = l_search or max(4 * k, index.config.l_build)
    d, ids, stats = index.search(queries, k=l, l_search=l, mode=mode)
    dev = index.device
    idt = torch.as_tensor(ids, device=dev)
    vecs = index.state.vectors[idt.long().clamp(0, index.state.capacity - 1)].float()
    sel = determinant_diversity_device(vecs, torch.as_tensor(d, device=dev),
                                       idt >= 0, k, power=power, eta=eta)
    sel = sel.cpu().numpy()
    take = np.clip(sel, 0, ids.shape[1] - 1)
    out_i = np.where(sel >= 0, np.take_along_axis(ids, take, 1), -1)
    out_d = np.where(sel >= 0, np.take_along_axis(d, take, 1), np.inf)
    return out_d, out_i, stats


def search_diverse(index, queries, attrs, k: int = 10, *, max_per_attribute: int = 1,
                   l_search: int | None = None, mode: str = "full",
                   enforce: str = "traversal", beam_width: int | None = None):
    """Diversity-aware k-NN: at most ``max_per_attribute`` results share
    an attribute value (``attrs``: one per point).

    enforce="post": search L, then apply the quota — blind to results
    beyond the plain top-L.  enforce="traversal": the navigation list
    itself carries a per-attribute quota of ``max_per_attribute * L / k``
    (the reference's local-queue capacity), so crowded attributes stop
    taking list slots and the walk keeps exploring.  Both finish with the
    same quota-constrained top-k."""
    l = l_search or max(4 * k, index.config.l_build)
    attrs = np.asarray(attrs)
    dev = index.device
    if enforce == "post":
        d, ids, stats = index.search(queries, k=l, l_search=l, mode=mode)
        d, ids = torch.as_tensor(d, device=dev), torch.as_tensor(ids, device=dev)
    elif enforce == "traversal":
        cap = index.state.capacity
        a_dev = torch.as_tensor(attrs.astype(np.int32), device=dev)
        # points past the attribute array never reach the results; their
        # own group keeps them from crowding a real attribute out
        a_dev = torch.nn.functional.pad(a_dev, (0, max(cap - a_dev.shape[0], 0)), value=-2)
        sdef, sdata, expand_r = index._scorer_for_mode(mode)
        cfg = index.config
        res = beam_search_scored(
            sdef, sdata, index.state.adjacency, index._start(), index._queries(queries),
            l_search=l, beam_width=beam_width or cfg.beam_width,
            max_hops=cfg.max_hops, history_capacity=cfg.history_capacity(l),
            expand_r=expand_r, diverse_attrs=a_dev,
            diverse_l=max(1, (max_per_attribute * l) // max(k, 1)),
        )
        d, ids = _filter_deleted(res.dists, res.ids, index.state.valid, l)
        stats = SearchStats(cmps=res.cmps.cpu().numpy(), hops=res.hops.cpu().numpy(),
                            result_count=(ids >= 0).sum(1).cpu().numpy())
    else:
        raise ValueError(f"unknown enforce mode {enforce!r}")
    od, oi = diverse_topk_device(d, ids, torch.as_tensor(attrs.astype(np.int32), device=dev),
                                 k, max_per_attribute)
    return od.cpu().numpy(), oi.cpu().numpy().astype(np.int64), stats
