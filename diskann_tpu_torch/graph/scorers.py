"""Scorers: the distance plug-in point of the search loop (PyTorch port of
the full-precision and packed pieces of `diskann_tpu/graph/scorers.py`).

A scorer is a `(ScorerDef, data)` pair: `ScorerDef` holds the callables,
`data` the tensors.  Two are ported: the full-precision scorer gathers raw
vectors and takes one float32 product per candidate set; the packed
fat-row scorer scores start points from the int8 self-codes and expands
beam nodes through the `fatrow_expand` kernel.

Integer products: the reference asks XLA for int8 x int8 -> int32 products.
Torch has no such CUDA matmul, and on the CPU an int8 matmul returns int8
and wraps.  Outside the kernel the products therefore run in float32, which
is exact here: every term is an integer and |sum| <= 127*127*dp < 2^24 for
dp <= 1024 — as long as TF32 is off on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from diskann_tpu_torch.graph.packed import words_to_f32
from diskann_tpu_torch.ops.distance import Metric, distance_to_set, squared_norms
from diskann_tpu_torch.ops.kernels.fatrow_expand import fatrow_expand


@dataclasses.dataclass(frozen=True)
class ScorerDef:
    """prep(data, queries) -> q_ctx            per-query precomputation
    score(data, q_ctx, ids, valid) -> d     [B, C] f32 distances (inf if invalid)
    expand(data, q_ctx, beam_ids, beam_valid) -> (cand_ids [B, C], d [B, C])
        scores all neighbours of the beam at once from a packed per-node
        layout."""

    name: str
    prep: Callable[[Any, torch.Tensor], Any]
    score: Callable[[Any, Any, torch.Tensor, torch.Tensor], torch.Tensor]
    expand: Callable | None = None


def full_precision_scorer(vectors, sq_norms, metric: Metric):
    """Full-precision scorer over the raw vectors: ``score`` gathers the
    candidates' rows and takes one batched float32 product."""

    def prep(data, queries):
        qsq = (squared_norms(queries) if metric.needs_norms
               else torch.zeros(queries.shape[0], device=queries.device))
        return (queries, qsq)

    def score(data, q_ctx, ids, valid):
        vecs, sqn = data
        q, qsq = q_ctx
        safe = torch.where(valid, ids, 0).long().clamp(0, vecs.shape[0] - 1)
        d = distance_to_set(q, vecs[safe], metric, x_sq_norms=sqn[safe],
                            q_sq_norms=qsq)
        return torch.where(valid, d, float("inf"))

    return ScorerDef(f"fp:{metric.value}", prep, score), (vectors, sq_norms)


def quantize_queries(queries, proj, pscale, pbias2, metric: Metric):
    """Project queries, center and scale them per dimension, and quantize
    each row symmetrically to int8.  Returns (qi [B, dp] i8, qscale [B],
    qb [B, dp] the centered projection, qs [B, dp] the scaled one)."""
    q = queries.float() @ proj
    qb = q - pbias2[None, :] if metric.needs_norms else q
    qs = qb * pscale[None, :]
    qscale = qs.abs().amax(1).clamp_min(1e-20) / 127.0
    qi = torch.round(qs / qscale[:, None]).clamp(-127, 127).to(torch.int8)
    return qi, qscale, qb, qs


def _packed_prep(metric: Metric):
    def prep(data, queries):
        rows, proj, pscale, pbias2, self_codes, self_aux = data
        qi, qscale, qb, _ = quantize_queries(queries, proj, pscale, pbias2, metric)
        return (qi, qscale, (qb * qb).sum(-1))

    return prep


def packed_scorer(packed, metric: Metric):
    """Fat-row packed scorer over a `PackedState`: `self_codes` score
    arbitrary ids (start points), `rows` serve beam expansion."""
    rp, dp = packed.r_pack, packed.dp
    nwr = packed.nwr

    def finish(cand, aux, dots, qsq, beam_valid, b, w):
        cand = torch.where(
            beam_valid.view(b, w, 1), cand.view(b, w, rp), -1
        ).view(b, w * rp)
        if metric == Metric.InnerProduct:
            d = -dots
        else:
            d = (qsq[:, None] + aux - 2.0 * dots).clamp_min(0.0)
        return cand, torch.where(cand >= 0, d, float("inf"))

    def score(data, q_ctx, ids, valid):
        rows, proj, pscale, pbias2, self_codes, self_aux = data
        qi, qscale, qsq = q_ctx
        n = self_codes.shape[0]
        safe = torch.where(valid, ids, 0).long().clamp(0, n - 1)
        c = self_codes[safe].float()                            # [B, C, dp]
        dots = (c @ qi.float()[:, :, None]).squeeze(-1) * qscale[:, None]
        if metric == Metric.InnerProduct:
            d = -dots
        else:
            d = (qsq[:, None] + self_aux[safe] - 2.0 * dots).clamp_min(0.0)
        return torch.where(valid, d, float("inf"))

    def expand(data, q_ctx, beam_ids, beam_valid):
        rows, proj, pscale, pbias2, self_codes, self_aux = data
        qi, qscale, qsq = q_ctx
        n = rows.shape[0] // nwr
        b, w = beam_ids.shape
        beam_flat = beam_ids.clamp(0, n - 1).reshape(b * w).to(torch.int32)
        qiw = qi.repeat_interleave(w, dim=0)
        ids_w, aux_w, dots_i = fatrow_expand(rows, beam_flat, qiw, rp=rp, dp=dp)
        cand = ids_w[:, :rp].reshape(b, w * rp)
        aux = words_to_f32(aux_w[:, :rp]).reshape(b, w * rp)
        dots = dots_i[:, :rp].reshape(b, w * rp).float() * qscale[:, None]
        return finish(cand, aux, dots, qsq, beam_valid, b, w)

    sdef = ScorerDef(f"packed:{metric.value}:{rp}x{dp}", _packed_prep(metric),
                     score, expand=expand)
    data = (packed.rows, packed.proj, packed.pscale, packed.pbias2,
            packed.self_codes, packed.self_aux)
    return sdef, data


def smallest_ids(d: torch.Tensor, ids: torch.Tensor, k: int) -> torch.Tensor:
    """ids of the k smallest entries of each row of d.  Up to 1024 columns
    a stable sort breaks ties toward the lower column, as the reference's
    exact ``lax.top_k`` does.  Wider rows use torch.topk: there the
    reference takes ``approx_min_k``, so no tie order is to be kept."""
    if d.shape[1] <= 1024:
        top = torch.sort(d, dim=1, stable=True).indices[:, :k]
    else:
        top = torch.topk(d, k, dim=1, largest=False, sorted=True).indices
    return ids[top]


def packed_router_starts(rc, raux, rids, proj, pscale, pbias2, queries,
                         metric: Metric, n_start: int) -> torch.Tensor:
    """Per-query entry points from a pre-gathered router table: one product
    of the int8-quantized query batch against ``rc [S, dp]`` (the packed
    self-codes of ``rids``), then the ``n_start`` nearest router ids.

    The reference takes approximate top-k here in its build (``exact=False``);
    the port is always exact (see `smallest_ids`)."""
    qi, qscale, qb, _ = quantize_queries(queries, proj, pscale, pbias2, metric)
    dots = (qi.float() @ rc.float().T) * qscale[:, None]
    if metric == Metric.InnerProduct:
        d = -dots
    else:
        d = (qb * qb).sum(-1, keepdim=True) + raux[None, :] - 2.0 * dots
    return smallest_ids(d, rids, n_start)
