"""Top-k and sorted-merge primitives (PyTorch port of `diskann_tpu/ops/topk.py`).

Beam-search best-lists are distance-sorted ``[B, L]`` rows.  Every sort that
carries a payload is a stable sort followed by a gather, which reproduces the
tie order of the reference's ``lax.sort(..., num_keys=1)``.
"""

from __future__ import annotations

import torch

# sort-to-the-end sentinel for int32 ids
SENTINEL = 2**31 - 1


def sort_with(keys: torch.Tensor, *payloads: torch.Tensor):
    """Stable ascending sort of ``keys`` along the last axis, carrying
    ``payloads`` (same shape) through the permutation."""
    sk, order = torch.sort(keys, dim=-1, stable=True)
    return (sk,) + tuple(torch.gather(p, -1, order) for p in payloads)


def sort_lex(k1: torch.Tensor, k2: torch.Tensor):
    """Lexicographic ascending sort by (k1, k2) along the last axis — the
    ``lax.sort(..., num_keys=2)`` of the reference — as two stable sorts."""
    k2s, k1s = sort_with(k2, k1)
    return sort_with(k1s, k2s)


def topk_smallest(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Smallest-k by distance with ids carried along, ascending."""
    sd, si = sort_with(dists, ids)
    return sd[..., :k], si[..., :k]


def merge_sorted(dists_a, ids_a, dists_b, ids_b, k: int, *extra_a_b):
    """Merge two per-row candidate lists, keep the k smallest, sorted.

    Extra per-entry payload arrays may be passed as (pa, pb) pairs."""
    if len(extra_a_b) % 2:
        raise ValueError("extra payloads come in (a, b) pairs")
    d = torch.cat([dists_a, dists_b], dim=-1)
    i = torch.cat([ids_a, ids_b], dim=-1)
    payloads = [
        torch.cat([extra_a_b[j], extra_a_b[j + 1]], dim=-1)
        for j in range(0, len(extra_a_b), 2)
    ]
    out = sort_with(d, i, *payloads)
    return tuple(o[..., :k] for o in out)


def merge_into_sorted(best_d, best_i, best_e, cd, ci, ce):
    """Merge C unsorted candidates into a sorted best-list of length L by
    computing every element's output rank and writing it with one scatter.

    Equivalent to a stable ascending sort of [best | candidates] truncated
    to L: existing entries precede new candidates of equal distance, and
    candidates keep their relative order."""
    b, l = best_d.shape
    c = cd.shape[1]
    iota = torch.arange(c, device=cd.device)
    lt = (cd[:, :, None] > cd[:, None, :]) | (
        (cd[:, :, None] == cd[:, None, :]) & (iota[:, None] > iota[None, :])
    )
    rank_cc = lt.sum(2)
    rank_cb = (best_d[:, None, :] <= cd[:, :, None]).sum(2)
    pos_c = rank_cb + rank_cc
    rank_bc = (cd[:, None, :] < best_d[:, :, None]).sum(2)
    pos_b = torch.arange(l, device=cd.device)[None, :] + rank_bc
    # slot l collects the overflow and is cut off below
    pos_b = pos_b.clamp_max(l)
    pos_c = pos_c.clamp_max(l)

    def scatter2(vb, vc, fill):
        out = torch.full((b, l + 1), fill, dtype=vb.dtype, device=vb.device)
        out.scatter_(1, pos_b, vb)
        out.scatter_(1, pos_c, vc)
        return out[:, :l]

    return (
        scatter2(best_d, cd, float("inf")),
        scatter2(best_i, ci, -1),
        scatter2(best_e, ce, 1),
    )


def mask_duplicates_any_order(ids: torch.Tensor) -> torch.Tensor:
    """Mark entries equal to an earlier-positioned entry (no sort)."""
    c = ids.shape[-1]
    eq = ids[:, :, None] == ids[:, None, :]
    iota = torch.arange(c, device=ids.device)
    earlier = iota[None, :] < iota[:, None]
    return (eq & earlier).any(2)


def isin_rows(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Row-wise membership: ``out[b, i] = any(ref[b, :] == x[b, i])``.

    The reference writes this as a broadcast compare, which XLA fuses; in
    eager torch the ``[B, C, M]`` bool cube would be materialized (1.2e9
    bytes for the multihop test at B=1024, C=3403, M=332; 2.5e8 per hop
    for the best-list test of the packed filtered walk at B=8192, C=336,
    M=90).  Here each ref row is sorted once and every x entry
    binary-searched in it: the same mask, in O(B (M + C) log M)."""
    sref = torch.sort(ref, dim=1).values
    pos = torch.searchsorted(sref, x.contiguous()).clamp_max(ref.shape[1] - 1)
    return sref.gather(1, pos) == x


def mask_duplicates_sorted(ids: torch.Tensor) -> torch.Tensor:
    """Given ids sorted along the last axis, mark second+ occurrences."""
    left = torch.cat(
        [torch.full_like(ids[..., :1], -2), ids[..., :-1]], dim=-1
    )
    return ids == left


def grouped_ranks(groups: torch.Tensor) -> torch.Tensor:
    """Occurrence rank of each element within its equal-value group:
    for position i, how many j < i share groups[j] == groups[i]."""
    b, l = groups.shape
    pos = torch.arange(l, device=groups.device).expand(b, l)
    # a stable sort by group keeps positions ascending inside each group
    ga, gp = sort_with(groups, pos)
    first = torch.cat(
        [torch.ones_like(ga[:, :1], dtype=torch.bool), ga[:, 1:] != ga[:, :-1]],
        dim=1,
    )
    seg_start = torch.where(first, pos, 0).cummax(1).values
    rank = pos - seg_start
    out = torch.empty_like(rank)
    out.scatter_(1, gp, rank)
    return out.to(torch.int32)
