"""Exact answers, in plain PyTorch: the nearest rows of a query by squared
L2 distance, the distance of given (query, row) pairs, recall@k and the
latency percentile.

Distances are settled in float64 from the vectors themselves, sum((q -
x)^2).  The top-k search first keeps the ``shortlist`` best rows of each
query by the float32 expansion |x|^2 - 2 q.x (TF32 off), which float32
rounding cannot reorder across that many places, then ranks the
shortlist in float64.

A label-filtered query (`topk_matching`) takes only the rows that carry
every tag of its predicate: the same search, with every other row's score
set to infinity before the shortlist, and -1 past the rows it may take
where fewer than k match.  Which rows match is worked out from the rows'
tags (CSR), a block of rows at a time (`matches`).
"""

from __future__ import annotations

import numpy as np
import torch

SHORTLIST = 64


def no_tf32() -> None:
    """Float32 products in float32: TF32 would round the inputs to 10 bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def wire(queries: torch.Tensor, query_dtype: str | None) -> torch.Tensor:
    """Float32 queries as the configuration's query wire delivers them
    (rounded through float16 or bfloat16 and back; None keeps them)."""
    if query_dtype is None:
        return queries
    return queries.to(getattr(torch, query_dtype)).float()


def pair_sqdist(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """float64 squared L2 distances: queries [B, d] against rows [B, k, d]."""
    diff = queries.double()[:, None, :] - rows.double()
    return (diff * diff).sum(-1)


def topk(queries: torch.Tensor, base: torch.Tensor, k: int, *,
         q_chunk: int = 2048, n_chunk: int = 131072,
         accept=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest rows of ``base`` [N, d] to each of ``queries`` [Q, d]:
    (float64 distances [Q, k] ascending, int64 row indices [Q, k]).

    ``accept(q0, q1, n0, n1)``, where given, is the [q1 - q0, n1 - n0] bool
    mask of the rows each query may take; a query with fewer than k of
    them gets distance inf and row -1 past them."""
    no_tf32()
    n = base.shape[0]
    kc = min(max(SHORTLIST, k), n)
    out_d, out_i = [], []
    for q0 in range(0, queries.shape[0], q_chunk):
        q = queries[q0:q0 + q_chunk].float()
        cand_s, cand_i = [], []
        for n0 in range(0, n, n_chunk):
            x = base[n0:n0 + n_chunk].float()
            s = (x * x).sum(-1)[None, :] - 2.0 * (q @ x.T)
            if accept is not None:
                s.masked_fill_(~accept(q0, q0 + q.shape[0], n0, n0 + x.shape[0]), float("inf"))
            v, i = torch.topk(s, min(kc, x.shape[0]), dim=1, largest=False)
            cand_s.append(v)
            cand_i.append(i + n0)
        s, i = torch.cat(cand_s, 1), torch.cat(cand_i, 1)
        v, j = torch.topk(s, kc, dim=1, largest=False)
        short = torch.gather(i, 1, j)                        # [q, kc]
        d = pair_sqdist(q, base[short])
        if accept is not None:
            d.masked_fill_(torch.isinf(v), float("inf"))
        d, o = torch.sort(d, dim=1, stable=True)
        out_d.append(d[:, :k])
        out_i.append(torch.gather(short, 1, o[:, :k]))
    d, i = torch.cat(out_d), torch.cat(out_i)
    if accept is not None:
        i.masked_fill_(torch.isinf(d), -1)
    return d, i


def matches(labels, preds: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """[Q, hi - lo] bool: which of rows [lo, hi) carry every tag of each of
    ``preds`` [Q, 2] (tag ids; a second -1: one tag).  ``labels`` is the
    rows' tags as CSR, (``indptr`` [N + 1], tag ids [nnz]), N >= hi."""
    indptr, tags = labels
    p = preds.long()
    used = torch.unique(p[p >= 0])
    at = slice(int(indptr[lo]), int(indptr[hi]))
    tg = tags[at].long()
    row = torch.repeat_interleave(torch.arange(hi - lo, device=tg.device),
                                  indptr[lo + 1:hi + 1] - indptr[lo:hi])
    pos = torch.searchsorted(used, tg).clamp_(max=used.shape[0] - 1)
    hit = used[pos] == tg
    carries = torch.zeros((used.shape[0], hi - lo), dtype=torch.bool, device=tg.device)
    carries[pos[hit], row[hit]] = True
    first = torch.searchsorted(used, p[:, 0].contiguous())
    second = torch.where(p[:, 1] >= 0, torch.searchsorted(used, p[:, 1].clamp(min=0)), first)
    return carries[first] & carries[second]


def topk_matching(queries: torch.Tensor, base: torch.Tensor, k: int, labels,
                  preds: torch.Tensor, lo: int = 0, **chunks):
    """The k nearest rows of ``base`` [N, d] to each of ``queries`` among
    the rows that match its predicate (``preds`` [Q, 2], `matches`), row
    ``r`` of ``base`` being row ``lo + r`` of ``labels``: `topk`'s
    (distances, rows), -1 past the matching rows, and how many rows of
    ``base`` match each query, int64 [Q]."""
    count = torch.zeros(queries.shape[0], dtype=torch.int64, device=queries.device)

    def accept(q0, q1, n0, n1):
        m = matches(labels, preds[q0:q1], lo + n0, lo + n1)
        count[q0:q1] += m.sum(1)
        return m

    d, i = topk(queries, base, k, accept=accept, **chunks)
    return d, i, count


def hits(rows: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """Per query, how many of the returned rows [B, k] (negative: none)
    are among the true rows [B, k]: recall@k times k (`knn_recall` of the
    port's bench/recall.py, per query)."""
    match = (rows[:, :, None] == truth[:, None, :]) & (rows[:, :, None] >= 0)
    return match.any(1).sum(1)


def percentile(values, p: float) -> float:
    """The p-th percentile, linearly interpolated (`np.percentile`, as the
    port's bench/stats.percentile_summary takes it)."""
    return float(np.percentile(np.asarray(values, np.float64), p))
