"""The comparison that decides ``correct``.

It reads what the timed path answered and judges it against the exact
answers, worked out again here from the seeded data alone:

- ``bad_ids``: returned entries that name no row live when the answer was
  given (a deleted row, a row never inserted, an empty slot, -1) or that
  repeat a row within one answer.  An acknowledged delete is never
  returned again, and every query gets k distinct live rows;
- ``dist_gap``: the widest gap between the distance the program returned
  for a row and that row's exact float64 distance from the query as the
  configuration's wire delivers it, over the larger of that distance and
  the answer's median one;
- ``recall_at_10``: the mean recall@k of every query answered, against the
  exact top-k over the rows live at that moment; ``recall_min``: the
  lowest of one search call's;
- ``insert_miss``: the share of acknowledged inserts, still live after
  the window, that a search for their own vector does not return in its
  top-k;
- ``failed_calls``: calls of the timed path that raised.

A label-filtered configuration (one predicate a query, `synth.Tagged`) is
judged against the exact top-k among the live rows that match the query's
predicate (`exact.topk_matching`): ``bad_ids`` also counts a returned row
that does not match, and each -1 beyond the k - min(k, matches) an answer
may hold; recall is the hits over the sum of min(k, matches), and
``recall_by_band`` (not compared; printed) splits it by the share of the
live rows a predicate matches.

The configuration's ``limits`` say which numbers a cell compares and the
limit of each.
"""

from __future__ import annotations

import numpy as np
import torch

from annbench.reference.exact import hits, pair_sqdist, topk, topk_matching, wire

# selectivity bands of ``recall_by_band``: the share of the live rows a
# predicate matches
BANDS = (("<0.1%", 0.001), ("0.1-1%", 0.01), (">1%", float("inf")))


def _repeats(rows: torch.Tensor) -> torch.Tensor:
    """[B, k] bool: entries that repeat an earlier one of their answer."""
    s, order = torch.sort(rows, dim=1)
    rep = torch.zeros_like(rows, dtype=torch.bool)
    rep[:, 1:] = s[:, 1:] == s[:, :-1]
    return torch.zeros_like(rep).scatter_(1, order, rep)


def _bad(rows: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """[B, k] bool: entries outside the live rows [lo, hi), or repeats."""
    return (rows < lo) | (rows >= hi) | _repeats(rows)


class _Tags:
    """Whether rows carry tags: the (row, tag) pairs of rows [0, n) as
    sorted keys row * vocab + tag, from `synth.Tagged`'s CSR."""

    def __init__(self, labels, n: int):
        indptr, tags = labels.rows(0, n)
        self.vocab = labels.vocab
        row = torch.repeat_interleave(torch.arange(n, device=tags.device),
                                      indptr[1:] - indptr[:-1])
        self.keys = row * self.vocab + tags.long()
        self.csr = (indptr, tags)

    def carry(self, rows: torch.Tensor, tags: torch.Tensor) -> torch.Tensor:
        want = rows.clamp(min=0) * self.vocab + tags.long().clamp(min=0)
        at = torch.searchsorted(self.keys, want).clamp_(max=self.keys.shape[0] - 1)
        return self.keys[at] == want

    def match(self, rows: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """[B, k] bool: ``rows`` [B, k] carry every tag of ``pred`` [B, 2]."""
        t1, t2 = (pred[:, i:i + 1].expand_as(rows) for i in (0, 1))
        return self.carry(rows, t1) & ((t2 < 0) | self.carry(rows, t2))


def measure(answers: list[dict], probes: list[dict], data, pool: torch.Tensor,
            *, k: int, query_dtype: str | None, failed: int, labels=None,
            preds: torch.Tensor | None = None) -> dict:
    """The numbers of one run.  ``answers``: one dict a search call, with
    the pool indices of its queries ``q`` [B], the returned rows ``rows``
    [B, k] (int64; negative where the program returned no live row) and
    distances ``dists`` [B, k], and ``live``, the rows [lo, hi) live when
    it was answered.  ``probes``: one dict a probe call, ``expect`` [P]
    the rows searched for and ``rows`` [P, k] what came back.  A filtered
    run gives ``labels`` (`synth.Tagged`) and ``preds``, the pool's
    predicates [pool, 2]."""
    dev = pool.device
    out = {"failed_calls": failed}
    if answers:
        hi_max = max(a["live"][1] for a in answers)
        x = data.rows(0, hi_max)
        wired = wire(pool, query_dtype)
        tagged = _Tags(labels, hi_max) if preds is not None else None
        n_bad, gap, n_hits, n_due, lowest = 0, 0.0, 0, 0, 1.0
        band_hits, band_due, band_q = (torch.zeros(len(BANDS), dtype=torch.float64, device=dev)
                                       for _ in range(3))
        groups: dict[tuple, list] = {}
        for a in answers:
            groups.setdefault(tuple(a["live"]), []).append(a)
        for (lo, hi), items in groups.items():
            uq = np.unique(np.concatenate([a["q"] for a in items]))
            uqd = torch.as_tensor(uq, device=dev)
            if tagged is None:
                _, truth = topk(pool[uqd], x[lo:hi], k)
                truth += lo
            else:
                _, truth, matched = topk_matching(pool[uqd], x[lo:hi], k, tagged.csr,
                                                  preds[uqd], lo)
                truth = torch.where(truth >= 0, truth + lo, -1)
            for a in items:
                q = torch.as_tensor(a["q"], device=dev)
                rows = torch.as_tensor(a["rows"], device=dev).long()
                d = torch.as_tensor(a["dists"], device=dev).double()
                pos = torch.as_tensor(np.searchsorted(uq, a["q"]), device=dev)
                if tagged is None:
                    bad = _bad(rows, lo, hi)
                    n_bad += int(bad.sum())
                    ok = ~bad
                    due = rows.shape[0] * k
                else:
                    m = matched[pos]
                    live = (rows >= lo) & (rows < hi)
                    bad = ((rows >= 0) & ~live) | ((rows >= 0) & _repeats(rows)) \
                        | (live & ~tagged.match(rows, preds[q]))
                    # an answer may hold k - min(k, matches) -1s, and no more
                    extra = ((rows < 0).sum(1) - (k - m.clamp(max=k))).clamp(min=0)
                    n_bad += int(bad.sum()) + int(extra.sum())
                    ok = ~bad & (rows >= 0)
                    due = int(m.clamp(max=k).sum())
                dref = pair_sqdist(wired[q], x[rows.clamp(0, hi - 1)])
                if ok.any():
                    scale = torch.maximum(dref, dref[ok].median())
                    rel = torch.nan_to_num((d - dref).abs() / scale, nan=float("inf"))
                    gap = max(gap, float(rel[ok].max()))
                per = hits(torch.where(ok, rows, -1), truth[pos])
                h = int(per.sum())
                n_hits += h
                n_due += due
                if due:
                    lowest = min(lowest, h / due)
                if tagged is not None:
                    band = torch.bucketize(m.double() / max(hi - lo, 1), torch.tensor(
                        [e for _, e in BANDS[:-1]], dtype=torch.float64, device=dev),
                        right=True)
                    for acc, w in ((band_hits, per), (band_due, m.clamp(max=k)),
                                   (band_q, torch.ones_like(m))):
                        acc += torch.bincount(band, weights=w.double(), minlength=len(BANDS))
        out.update(bad_ids=n_bad, dist_gap=gap, recall_at_10=n_hits / n_due if n_due else 1.0,
                   recall_min=lowest)
        if tagged is not None:
            out["recall_by_band"] = {
                name: {"recall": float(band_hits[b] / band_due[b]) if band_due[b] else None,
                       "queries": int(band_q[b])} for b, (name, _) in enumerate(BANDS)}
    if probes:
        miss = sum(int((~(p["rows"] == p["expect"][:, None]).any(1)).sum()) for p in probes)
        out["insert_miss"] = miss / sum(len(p["expect"]) for p in probes)
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, list[dict]]:
    """Each number the configuration limits, beside its limit.  A number
    the run could not give fails."""
    rows = []
    for name, lim in limits.items():
        (rel, bound), = lim.items()
        v = numbers.get(name)
        ok = v is not None and (v <= bound if rel == "max" else v >= bound)
        rows.append({"name": name, "value": v, "limit": bound, "rel": rel, "ok": ok})
    rows.append({"name": "failed_calls", "value": numbers["failed_calls"], "limit": 0,
                 "rel": "max", "ok": numbers["failed_calls"] == 0})
    return all(r["ok"] for r in rows), rows
