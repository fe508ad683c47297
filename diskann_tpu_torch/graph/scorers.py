"""Scorers: the distance plug-in point of the search loop (PyTorch port of
`diskann_tpu/graph/scorers.py`).

A scorer is a `(ScorerDef, data)` pair: `ScorerDef` holds the callables,
`data` the tensors.

- full precision: gathers raw vectors, one float32 product per candidate
  set;
- packed fat rows: scores start points from the int8 self-codes and
  expands beam nodes through the `fatrow_expand` kernel;
- PQ: per-query ADC tables [B, m*k], one gather of table entries per
  candidate code and a sum over chunks;
- SQ and MinMax: int8 rows with the dequantization folded into the score;
- spherical: bit-packed rotated codes, unpacked on the fly.

Integer products: the reference asks XLA for int8 x int8 -> int32 products.
Torch has no such CUDA matmul, and on the CPU an int8 matmul returns int8
and wraps.  Outside the kernel the products therefore run in float32, which
is exact here: every term is an integer and |sum| <= 127*127*d < 2^24 for
d <= 1040 — as long as TF32 is off on the card.

Eager torch materializes every broadcast, so the reference's 4-bit PQ form
(a masked [B, C, m, k] reduction that XLA fuses) would cost ~11 GB per hop
at the 1M shape; both PQ widths take the table gather here, the same
function up to the order of the float sums.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from diskann_tpu_torch.graph.packed import words_to_f32
from diskann_tpu_torch.ops.distance import Metric, distance_to_set, squared_norms
from diskann_tpu_torch.ops.kernels.fatrow_expand import fatrow_expand
from diskann_tpu_torch.quant.bits import unpack_bits

_INF = float("inf")

# largest dimension whose int8 dot is exact in float32: d * 127^2 < 2^24
_MAX_EXACT_DIM = (2**24 - 1) // (127 * 127)


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
        safe = _safe(ids, valid, vecs.shape[0])
        d = distance_to_set(q, vecs[safe], metric, x_sq_norms=sqn[safe],
                            q_sq_norms=qsq)
        return torch.where(valid, d, _INF)

    return ScorerDef(f"fp:{metric.value}", prep, score), (vectors, sq_norms)


def quantize_queries(queries, proj, pscale, pbias2, metric: Metric):
    """Project queries (``proj`` None: as they are), center and scale them
    per dimension, and quantize each row symmetrically to int8.  Returns
    (qi [B, dp] i8, qscale [B], qb [B, dp] the centered projection, qs
    [B, dp] the scaled one)."""
    q = queries.float() if proj is None else queries.float() @ proj
    qb = q - pbias2[None, :] if metric.needs_norms else q
    qs = qb * pscale[None, :]
    qscale = qs.abs().amax(1).clamp_min(1e-20) / 127.0
    qi = torch.round(qs / qscale[:, None]).clamp(-127, 127).to(torch.int8)
    return qi, qscale, qb, qs


def _int8_dots(codes, safe, qi, qscale):
    """Dots of the int8 rows ``codes[safe]`` [B, C, d] with the int8 query
    rows, in float32 (exact, see the module note), times each query's
    scale: [B, C]."""
    c = codes[safe].float()
    return (c @ qi.float()[:, :, None]).squeeze(-1) * qscale[:, None]


def _safe(ids, valid, n):
    return torch.where(valid, ids, 0).long().clamp(0, n - 1)


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
        safe = _safe(ids, valid, self_codes.shape[0])
        dots = _int8_dots(self_codes, safe, qi, qscale)
        if metric == Metric.InnerProduct:
            d = -dots
        else:
            d = (qsq[:, None] + self_aux[safe] - 2.0 * dots).clamp_min(0.0)
        return torch.where(valid, d, _INF)

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


def pq_scorer(codes, pivots, metric: Metric):
    """PQ scorer.  codes: [N, m] uint8; pivots: [m, k, ds] codebooks.
    ``prep`` builds each query's [m*k] ADC table (squared L2 per chunk, or
    the negated dot for inner product; cosine rides on normalized
    pivots); ``score`` gathers and sums one entry per chunk."""

    def prep(data, queries):
        codes, pivots = data
        m, k, ds = pivots.shape
        b = queries.shape[0]
        q = queries.float()
        qc = torch.nn.functional.pad(q, (0, m * ds - q.shape[1])).view(b, m, ds)
        dots = torch.einsum("bmd,mkd->bmk", qc, pivots.float())
        if metric == Metric.L2:
            psq = (pivots.float() ** 2).sum(-1)
            qsq = (qc * qc).sum(-1)
            lut = qsq[:, :, None] + psq[None] - 2.0 * dots
        else:
            lut = -dots
        return lut.reshape(b, m * k)

    def score(data, q_ctx, ids, valid):
        codes, pivots = data
        m, k, _ = pivots.shape
        b, c = ids.shape
        safe = _safe(ids, valid, codes.shape[0])
        flat = codes[safe].long() + torch.arange(m, device=ids.device) * k
        d = q_ctx.gather(1, flat.view(b, c * m)).view(b, c, m).sum(-1)
        return torch.where(valid, d, _INF)

    return ScorerDef(f"pq:{metric.value}", prep, score), (codes, pivots)


def sq_center_codes(codes_u8, scale, bias):
    """uint8 codes -> centered int8 codes and the adjusted bias
    (bias2 = bias + 128 * scale)."""
    return (codes_u8.to(torch.int32) - 128).to(torch.int8), bias + 128.0 * scale


def sq_aux_norms(codes_i8, scale) -> torch.Tensor:
    """||scale * code||^2 per row (the L2 / cosine term)."""
    cs = codes_i8.float() * scale[None, :]
    return (cs * cs).sum(-1)


def sq_scorer(codes_i8, scale, bias2, aux, metric: Metric):
    """Scalar-quantized scorer over centered int8 codes: the query is
    quantized to int8 per row, so a candidate's dot is one int8 product
    (in float32, exact up to d = 1040)."""
    if codes_i8.shape[1] > _MAX_EXACT_DIM:
        raise ValueError(f"sq_scorer: d={codes_i8.shape[1]} > {_MAX_EXACT_DIM}, "
                         "where float32 int8 dots stop being exact")

    def prep(data, queries):
        codes, scale, bias2, aux = data
        qi, qscale, qb, _ = quantize_queries(queries, None, scale, bias2, metric)
        return (qi, qscale, (qb * qb).sum(-1))

    def score(data, q_ctx, ids, valid):
        codes, scale, bias2, aux = data
        qi, qscale, qsq = q_ctx
        safe = _safe(ids, valid, codes.shape[0])
        dots = _int8_dots(codes, safe, qi, qscale)
        if metric == Metric.InnerProduct:
            d = -dots   # ranking-equivalent (the per-query constant dropped)
        else:
            d = (qsq[:, None] + aux[safe] - 2.0 * dots).clamp_min(0.0)
        return torch.where(valid, d, _INF)

    return ScorerDef(f"sq:{metric.value}", prep, score), (codes_i8, scale, bias2, aux)


def minmax_scorer(codes_i8, lo, step, aux, metric: Metric):
    """MinMax scorer: centered int8 rows with their own (lo, step); the
    decoded dot folds into q . xhat = step * (q . c) + (lo + 128 step) *
    sum(q)."""

    def prep(data, queries):
        q = queries.float()
        return (q, q.sum(1), (q * q).sum(1))

    def score(data, q_ctx, ids, valid):
        codes, lo, step, aux = data
        q, qsum, qsq = q_ctx
        safe = _safe(ids, valid, codes.shape[0])
        raw = (codes[safe].float() @ q[:, :, None]).squeeze(-1)
        st = step[safe]
        dot_qy = st * raw + (lo[safe] + 128.0 * st) * qsum[:, None]
        if metric == Metric.InnerProduct:
            d = -dot_qy
        else:
            d = qsq[:, None] + aux[safe] - 2.0 * dot_qy
        return torch.where(valid, d, _INF)

    return ScorerDef(f"mm:{metric.value}", prep, score), (codes_i8, lo, step, aux)


def spherical_scorer(words, norms, cscale, rotation, dim: int, n_bits: int,
                     metric: Metric):
    """Bit-packed spherical scorer: candidates' int32 words are gathered
    and unpacked to [B, C, dim] codes for one float32 product with the
    rotated query."""
    lv = float((1 << n_bits) - 1)

    def prep(data, queries):
        words, norms, cscale, rotation = data
        qr = queries.float() @ rotation
        return (qr, qr.sum(1), (qr * qr).sum(1))

    def score(data, q_ctx, ids, valid):
        words, norms, cscale, rotation = data
        qr, qsum, qsq = q_ctx
        safe = _safe(ids, valid, words.shape[0])
        codes = unpack_bits(words[safe], n_bits, dim).float()      # [B, C, dim]
        raw = (codes @ qr[:, :, None]).squeeze(-1)
        dot_qy = norms[safe] * cscale[safe] * ((2.0 / lv) * raw - qsum[:, None])
        if metric == Metric.InnerProduct:
            d = -dot_qy
        else:
            d = qsq[:, None] + norms[safe] ** 2 - 2.0 * dot_qy
        return torch.where(valid, d, _INF)

    sdef = ScorerDef(f"sph:{metric.value}:{n_bits}b", prep, score)
    return sdef, (words, norms, cscale, rotation)


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
