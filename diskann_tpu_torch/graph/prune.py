"""Batched RobustPrune (alpha-occlusion pruning) — PyTorch port of
`diskann_tpu/graph/prune.py`.

Semantics of DiskANN's ``occlude_list`` for the TriangleInequality rule:
the candidate pool is sorted ascending by distance to the pruned point;
alpha runs a ladder 1.0 -> alpha; within a rung, pool positions are scanned
in order and promoted when their occlusion factor against the earlier
promoted neighbours is <= the rung's alpha; factors accumulate across
rungs; promotion stops at ``degree``.

The in-order scan is the reference's fixed-point form: each step examines
the first K eligible positions of every row, promotes the prefix-consistent
subset (position i is promoted iff the positions promoted before it in the
same step do not occlude it), then applies all promoted neighbours'
occlusion to the whole pool with one batched product.  The loop checks for
remaining eligible positions once per step: `robust_prune_steps` yields
the flag (`graph/steps.py`), `robust_prune` answers it in the calling
thread.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from diskann_tpu_torch.graph import steps
from diskann_tpu_torch.graph.config import OCCLUDING_MASK, GraphConfig, PruneKind
from diskann_tpu_torch.ops.distance import Metric, squared_norms
from diskann_tpu_torch.ops.topk import SENTINEL, mask_duplicates_sorted, sort_with

_INF = float("inf")


class PruneResult(NamedTuple):
    ids: torch.Tensor     # [B, R] i32 selected neighbours in promotion order, -1 pad
    dists: torch.Tensor   # [B, R] f32 distance of each selected neighbour to p
    count: torch.Tensor   # [B] i32


def _set_distance(q, qsq, x, xsq, metric: Metric):
    """Distances between the rows of q [B, K, d] and x [B, C, d]: [B, K, C]
    (the reference's `distance_to_set` per batch row, same float order)."""
    if metric == Metric.L1:
        return (q[:, :, None, :] - x[:, None, :, :]).abs().sum(-1)
    dots = q @ x.transpose(1, 2)
    if metric == Metric.InnerProduct:
        return -dots
    if metric == Metric.CosineNormalized:
        return 1.0 - dots
    if metric == Metric.L2:
        return (qsq[:, :, None] + xsq[:, None, :] - 2.0 * dots).clamp_min(0.0)
    denom = (qsq[:, :, None] * xsq[:, None, :]).clamp_min(1e-60).sqrt()
    return 1.0 - dots / denom


def _occlude_scan_steps(pool_d, pool_vecs, pool_sq, valid, *, degree: int,
                        alpha_ladder: tuple, kind: PruneKind, metric: Metric,
                        saturate: bool):
    """pool_d [B, C] ascending (inf invalid), pool_vecs [B, C, d], pool_sq
    [B, C], valid [B, C].  Yields each step's "any position eligible" flag
    and ends the rung on a False answer.  Returns (sel_pos [B, degree] pool
    positions in promotion order, C = empty; found [B])."""
    b, c = pool_d.shape
    dev = pool_d.device
    occ = torch.where(valid, 0.0, _INF)
    selected = torch.zeros((b, c), dtype=torch.bool, device=dev)
    found = torch.zeros(b, dtype=torch.int32, device=dev)
    # column `degree` is the drop slot for writes past the degree
    sel_pos = torch.full((b, degree + 1), c, dtype=torch.int64, device=dev)
    pos = torch.arange(c, device=dev).expand(b, c)
    kk = max(min(16, degree, c), 1)
    k_iota = torch.arange(kk, device=dev)[None, :]
    earlier = k_iota.T > k_iota                    # [Ki, Kj]: j < i

    for alpha in alpha_ladder:
        # filled on the device: a host scalar copied there would wait for
        # the card's queue to drain
        alpha_f = torch.full((), alpha, dtype=torch.float32, device=dev)
        knock = torch.full((), alpha + OCCLUDING_MASK, dtype=torch.float32, device=dev)
        while True:
            eligible = (occ <= alpha_f) & ~selected & valid & (found[:, None] < degree)
            if not (yield eligible.any()):
                break
            room = (degree - found).clamp_max(kk)
            # first K eligible positions per row, ascending (c = none)
            pos_k = -torch.topk(torch.where(eligible, -pos, -c), kk, dim=1).values
            k_live = (pos_k < c) & (k_iota < room[:, None])
            safe_k = pos_k.clamp_max(c - 1)
            jvecs = pool_vecs.gather(1, safe_k[:, :, None].expand(-1, -1, pool_vecs.shape[2]))
            jsq = pool_sq.gather(1, safe_k)
            jpd = pool_d.gather(1, safe_k)

            # prefix-consistent promotion among the K examined: i is promoted
            # iff it is live and no promoted j < i blocks it, where j blocks
            # i when its occlusion factor on i exceeds the rung's alpha
            # (TriangleInequality; a NaN factor blocks, as it fails <=) or
            # knocks it out (Occluding: knock > alpha).  The whole [Kj, Ki]
            # block is decided at once, so each i costs a few ops.
            dd = _set_distance(jvecs, jsq, jvecs, jsq, metric)   # [B, Kj, Ki]
            if kind == PruneKind.TriangleInequality:
                ratio = torch.where(dd == 0.0, _INF, jpd[:, None, :] / dd)
                blocks = ~(ratio <= alpha_f)
            else:
                blocks = dd < alpha_f * jpd[:, None, :]
            blocks = blocks.transpose(1, 2) & earlier      # [B, Ki, Kj], j < i
            promote = k_live.clone()
            for i in range(1, kk):
                col = promote[:, i]
                col &= ~(promote & blocks[:, i]).any(1)

            # pool-wide occlusion from all promoted at once: [B, K, C]
            jk = _set_distance(jvecs, jsq, pool_vecs, pool_sq, metric)
            later = pos[:, None, :] > pos_k[:, :, None]
            apply = promote[:, :, None] & later
            if kind == PruneKind.TriangleInequality:
                ratio = torch.where(jk == 0.0, _INF, pool_d[:, None, :] / jk)
                contrib = torch.where(apply, ratio, -_INF).amax(1)
                occ = torch.maximum(occ, contrib)
            else:
                knocked = (apply & (jk < alpha_f * pool_d[:, None, :])).any(1)
                occ = torch.where(knocked, knock, occ)

            hit = ((pos[:, None, :] == pos_k[:, :, None]) & promote[:, :, None]).any(1)
            selected = selected | hit
            csum = promote.cumsum(1)
            slot_w = torch.where(promote, found[:, None] + csum - 1, degree).long()
            sel_pos.scatter_(1, slot_w, pos_k)
            found = found + csum[:, -1].to(torch.int32)

    if saturate:
        # fill remaining slots in pool order with unselected valid candidates
        fillable = valid & ~selected
        rank = fillable.cumsum(1) - 1
        slot = found[:, None] + rank
        take = fillable & (slot < degree)
        sel_pos.scatter_(1, torch.where(take, slot, degree).long(), pos)
        found = (found + take.sum(1, dtype=torch.int32)).clamp_max(degree)

    return sel_pos[:, :degree], found


def robust_prune(
    p_vecs: torch.Tensor,                 # [B, d] points being pruned
    cand_ids: torch.Tensor,               # [B, C] candidate ids (-1 invalid)
    cand_dists: torch.Tensor | None,      # [B, C] d(p, candidate); None -> recompute
    cand_vecs: torch.Tensor,              # [B, C, d] candidate vectors
    self_ids: torch.Tensor,               # [B] id of each pruned point
    config: GraphConfig,
    *,
    degree: int | None = None,
    saturate: bool | None = None,
) -> PruneResult:
    """Batched RobustPrune of B candidate pools: id dedup, self exclusion,
    sort by distance, occlusion scan.  Returns up to ``degree`` neighbours
    per row in promotion order."""
    return steps.run(robust_prune_steps(**locals()))


def robust_prune_steps(
    p_vecs: torch.Tensor,                 # [B, d] points being pruned
    cand_ids: torch.Tensor,               # [B, C] candidate ids (-1 invalid)
    cand_dists: torch.Tensor | None,      # [B, C] d(p, candidate); None -> recompute
    cand_vecs: torch.Tensor,              # [B, C, d] candidate vectors
    self_ids: torch.Tensor,               # [B] id of each pruned point
    config: GraphConfig,
    *,
    degree: int | None = None,
    saturate: bool | None = None,
):
    """The stepping form of `robust_prune` (`graph/steps.py`): yields the
    occlusion scan's flags; returns what `robust_prune` returns."""
    b, c = cand_ids.shape
    metric = config.metric
    if cand_dists is None:
        psq = squared_norms(p_vecs) if metric.needs_norms else None
        csq = squared_norms(cand_vecs) if metric.needs_norms else None
        cand_dists = _set_distance(
            p_vecs[:, None, :], None if psq is None else psq[:, None],
            cand_vecs, csq, metric,
        ).squeeze(1)
    degree = degree if degree is not None else config.max_degree
    if saturate is None:
        saturate = config.saturate_after_prune and config.alpha > 1.0

    # --- dedup by id + drop self loops ---
    invalid = (cand_ids < 0) | (cand_ids == self_ids[:, None])
    key = torch.where(invalid, SENTINEL, cand_ids)
    key_sorted, order = torch.sort(key, dim=1, stable=True)
    dup = torch.zeros_like(invalid)
    dup.scatter_(1, order, mask_duplicates_sorted(key_sorted))
    valid = ~invalid & ~dup & (key != SENTINEL)

    # --- sort pool ascending by distance (invalid to the end) ---
    perm0 = torch.arange(c, device=cand_ids.device).expand(b, c)
    pool_d, perm = sort_with(torch.where(valid, cand_dists, _INF), perm0)
    pool_ids = cand_ids.gather(1, perm)
    pool_vecs = cand_vecs.gather(1, perm[:, :, None].expand(-1, -1, cand_vecs.shape[2]))
    pool_valid = valid.gather(1, perm)
    pool_sq = (squared_norms(pool_vecs) if metric.needs_norms
               else torch.zeros((b, c), device=pool_d.device))

    sel_pos, found = yield from _occlude_scan_steps(
        pool_d, pool_vecs, pool_sq, pool_valid,
        degree=degree, alpha_ladder=config.alpha_ladder(),
        kind=config.prune_kind, metric=metric, saturate=saturate,
    )
    slot_valid = torch.arange(degree, device=found.device)[None, :] < found[:, None]
    safe = sel_pos.clamp_max(c - 1)
    out_ids = torch.where(slot_valid, pool_ids.gather(1, safe), -1)
    out_d = torch.where(slot_valid, pool_d.gather(1, safe), _INF)
    return PruneResult(ids=out_ids, dists=out_d, count=found)
