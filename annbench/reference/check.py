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

The configuration's ``limits`` say which numbers a cell compares and the
limit of each.
"""

from __future__ import annotations

import numpy as np
import torch

from annbench.reference.exact import hits, pair_sqdist, topk, wire


def _bad(rows: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """[B, k] bool: entries outside the live rows [lo, hi), or repeats."""
    bad = (rows < lo) | (rows >= hi)
    s, order = torch.sort(rows, dim=1)
    rep = torch.zeros_like(bad)
    rep[:, 1:] = s[:, 1:] == s[:, :-1]
    return bad | torch.zeros_like(bad).scatter_(1, order, rep)


def measure(answers: list[dict], probes: list[dict], data, pool: torch.Tensor,
            *, k: int, query_dtype: str | None, failed: int) -> dict:
    """The numbers of one run.  ``answers``: one dict a search call, with
    the pool indices of its queries ``q`` [B], the returned rows ``rows``
    [B, k] (int64; negative where the program returned no live row) and
    distances ``dists`` [B, k], and ``live``, the rows [lo, hi) live when
    it was answered.  ``probes``: one dict a probe call, ``expect`` [P]
    the rows searched for and ``rows`` [P, k] what came back."""
    dev = pool.device
    out = {"failed_calls": failed}
    if answers:
        hi_max = max(a["live"][1] for a in answers)
        x = data.rows(0, hi_max)
        wired = wire(pool, query_dtype)
        n_bad, gap, n_hits, n_q, lowest = 0, 0.0, 0, 0, 1.0
        groups: dict[tuple, list] = {}
        for a in answers:
            groups.setdefault(tuple(a["live"]), []).append(a)
        for (lo, hi), items in groups.items():
            uq = np.unique(np.concatenate([a["q"] for a in items]))
            _, truth = topk(pool[torch.as_tensor(uq, device=dev)], x[lo:hi], k)
            truth += lo
            for a in items:
                q = torch.as_tensor(a["q"], device=dev)
                rows = torch.as_tensor(a["rows"], device=dev).long()
                d = torch.as_tensor(a["dists"], device=dev).double()
                bad = _bad(rows, lo, hi)
                n_bad += int(bad.sum())
                ok = ~bad
                dref = pair_sqdist(wired[q], x[rows.clamp(0, hi - 1)])
                if ok.any():
                    scale = torch.maximum(dref, dref[ok].median())
                    rel = torch.nan_to_num((d - dref).abs() / scale, nan=float("inf"))
                    gap = max(gap, float(rel[ok].max()))
                pos = torch.as_tensor(np.searchsorted(uq, a["q"]), device=dev)
                h = int(hits(torch.where(ok, rows, -1), truth[pos]).sum())
                n_hits += h
                n_q += rows.shape[0]
                lowest = min(lowest, h / (rows.shape[0] * k))
        out.update(bad_ids=n_bad, dist_gap=gap, recall_at_10=n_hits / (n_q * k),
                   recall_min=lowest)
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
