"""Packed neighbour "fat-row" word layout and its upkeep (PyTorch port of
`diskann_tpu/graph/packed.py`).

One logical fat row per node holds everything a beam expansion needs,
stored as a run of ``nwr`` 128-word int32 rows in one flat
``[(cap+1) * nwr, 128] int32`` table:

    word-rows [0, idw)        ids   (r_pack x i32, -1-padded tail)
    word-rows [idw, 2*idw)    aux   (r_pack x f32 bit patterns, +inf empty)
    word-rows [2*idw, ...)    codes (r_pack x dp int8, 4 per word,
                              little-endian), then zero pad rows so nwr is
                              a multiple of 8

Row ``cap`` is a sacrificial dump row: writes for invalid targets land
there instead of being masked one by one.  The layout is byte-identical to
the reference's, so tables move between the two packages unchanged.

The table is updated in place (`refresh_rows` through the `block_patch`
kernel, `append_edges` through an indexed store), where the reference
donated it to its jitted updates: a second copy of a 12 GB table would not
fit next to the first.  Every flat word offset is int64, so the reference's
2^31-word limit on writable tables (its TPU scatters index in int32) does
not apply here.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from diskann_tpu_torch.graph.state import RowJournal
from diskann_tpu_torch.ops.distance import Metric
from diskann_tpu_torch.ops.kernels.block_patch import block_patch


def padded_degree(r_slack: int, dp: int) -> int:
    """Smallest r >= r_slack with (r * dp) % 512 == 0 (code words fill
    whole 128-word rows)."""
    dpw = dp // 4
    step = 128 // math.gcd(dpw, 128)
    return -(-r_slack // step) * step


def id_wrows(r_pack: int) -> int:
    """128-word rows holding the id section (= aux section) of a fat row."""
    return -(-r_pack // 128)


def code_wrows(r_pack: int, dp: int) -> int:
    """128-word rows holding the code section."""
    return -(-(r_pack * (dp // 4)) // 128)


def n_wrows(r_pack: int, dp: int) -> int:
    """Total 128-word int32 rows per logical fat row, rounded up to a
    multiple of 8 (one `block_patch` block is 8 rows)."""
    w = 2 * id_wrows(r_pack) + code_wrows(r_pack, dp)
    return -(-w // 8) * 8


@dataclasses.dataclass
class PackedState:
    proj: torch.Tensor        # [d, dp] f32 projection (PCA)
    pscale: torch.Tensor      # [dp] f32 per-dim quant scale
    pbias2: torch.Tensor      # [dp] f32 adjusted bias (bias + 128*scale)
    self_codes: torch.Tensor  # [cap, dp] i8
    self_aux: torch.Tensor    # [cap] f32 (||code||^2 for L2; 0 for IP)
    rows: torch.Tensor        # [(cap+1)*nwr, 128] i32 word table
    r_pack: int               # neighbour slots per row

    @property
    def dp(self) -> int:
        return self.proj.shape[1]

    @property
    def idw(self) -> int:
        return id_wrows(self.r_pack)

    @property
    def nwr(self) -> int:
        return n_wrows(self.r_pack, self.dp)

    @property
    def aux_off_w(self) -> int:
        """Word offset of the aux section within a flattened logical row."""
        return self.idw * 128

    @property
    def code_off_w(self) -> int:
        """Word offset of the code section within a flattened logical row."""
        return 2 * self.idw * 128


def train_packed(vectors: np.ndarray, dp: int, metric: Metric, *,
                 sigma: float = 4.0, device=None):
    """Fit the projection + quantization params on (a sample of) vectors.
    Returns float32 tensors (proj [d, dp], pscale [dp], pbias2 [dp])."""
    del metric  # same fit for every metric, as in the reference
    vecs = np.asarray(vectors, np.float32)
    d = vecs.shape[1]
    dp = min(dp, d)
    # dp/4 must divide 128 so a code never straddles a 128-word row
    while dp % 4 or 128 % (dp // 4):
        dp -= 1
    mu = vecs.mean(axis=0)
    cov = np.cov((vecs - mu).T).astype(np.float32)
    if cov.ndim == 0:  # d == 1
        cov = cov.reshape(1, 1)
    evals, evecs = np.linalg.eigh(cov)
    proj = np.ascontiguousarray(evecs[:, ::-1][:, :dp]).astype(np.float32)
    p = vecs @ proj
    mean, std = p.mean(axis=0), p.std(axis=0)
    lo, hi = mean - sigma * std, mean + sigma * std
    scale = np.maximum(hi - lo, 1e-12) / 255.0
    bias2 = lo + 128.0 * scale
    return tuple(
        torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
        for a in (proj, scale, bias2)
    )


INF_BITS = int(np.float32(np.inf).view(np.int32))


def _empty_rows(n: int, r_pack: int, dp: int, *, device=None) -> torch.Tensor:
    """Word rows for n empty fat rows: ids -1, aux +inf, codes zero.
    Shape [n*nwr, 128]."""
    idw = id_wrows(r_pack)
    nwr = n_wrows(r_pack, dp)
    tmpl = torch.zeros((nwr * 128,), dtype=torch.int32, device=device)
    tmpl[: idw * 128] = -1
    tmpl[idw * 128 : 2 * idw * 128] = INF_BITS
    return tmpl.view(nwr, 128).repeat(n, 1)


def alloc_packed(proj, pscale, pbias2, capacity: int, r_slack: int, *,
                 writable: bool = True) -> PackedState:
    """An empty packed state for `capacity` nodes (+1 dump row), on the
    device of `proj`.  ``writable`` is taken and changes nothing: the
    reference refuses a writable table of 2^31 words or more because its
    scatters index in int32; every table here indexes in int64."""
    del writable
    dev = proj.device
    dp = proj.shape[1]
    rp = padded_degree(r_slack, dp)
    return PackedState(
        proj=proj,
        pscale=pscale,
        pbias2=pbias2,
        self_codes=torch.zeros((capacity, dp), dtype=torch.int8, device=dev),
        self_aux=torch.zeros((capacity,), device=dev),
        rows=_empty_rows(capacity + 1, rp, dp, device=dev),
        r_pack=rp,
    )


def grow_packed(packed: PackedState, new_capacity: int) -> PackedState:
    cap = packed.self_codes.shape[0]
    extra = new_capacity - cap
    if extra <= 0:
        return packed
    f = torch.nn.functional.pad
    # drop the old dump row (it holds garbage and must not become node
    # slot `cap`); the fresh empties include a new dump row
    return dataclasses.replace(
        packed,
        self_codes=f(packed.self_codes, (0, 0, 0, extra)),
        self_aux=f(packed.self_aux, (0, extra)),
        rows=torch.cat(
            [packed.rows[: cap * packed.nwr],
             _empty_rows(extra + 1, packed.r_pack, packed.dp,
                         device=packed.rows.device)],
            dim=0,
        ),
    )


def encode(packed: PackedState, vecs: torch.Tensor, metric: Metric):
    """-> (codes [M, dp] i8, aux [M] f32)."""
    xp = vecs.float() @ packed.proj
    t = (xp - packed.pbias2[None, :]) / packed.pscale[None, :]
    codes = torch.round(t).clamp(-128, 127).to(torch.int8)
    if metric == Metric.InnerProduct:
        return codes, torch.zeros(vecs.shape[0], device=vecs.device)
    cs = codes.float() * packed.pscale[None, :]
    return codes, (cs * cs).sum(-1)


def set_self_codes(packed: PackedState, slot_ids, codes, aux,
                   journal: RowJournal | None = None) -> PackedState:
    """Write codes/aux at `slot_ids` in place; negative slots are skipped.
    ``journal`` keeps the rows first."""
    keep = slot_ids >= 0
    w = slot_ids[keep].long()
    if journal is not None:
        journal.save(packed.self_codes, w)
        journal.save(packed.self_aux, w)
    packed.self_codes[w] = codes[keep]
    packed.self_aux[w] = aux[keep]
    return packed


def codes_to_words(codes: torch.Tensor) -> torch.Tensor:
    """[..., dp] i8 -> [..., dp/4] i32 (little-endian bit cast)."""
    return codes.contiguous().view(torch.int32)


def words_to_codes(words: torch.Tensor, dp: int) -> torch.Tensor:
    """[..., dp/4] i32 -> [..., dp] i8."""
    return words.contiguous().view(torch.int8).reshape(*words.shape[:-1], dp)


def f32_to_words(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def words_to_f32(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.float32)


def row_nbytes(r_pack: int, dp: int) -> int:
    """Fat-row byte width (all word rows of one logical row)."""
    return n_wrows(r_pack, dp) * 512


def logical_rows(packed: PackedState) -> torch.Tensor:
    """The word table viewed as [cap+1, nwr*128] flattened logical rows
    (decode with the `*_off_w` word offsets)."""
    return packed.rows.view(-1, packed.nwr * 128)


def refresh_rows(packed: PackedState, adjacency: torch.Tensor, rows,
                 journal: RowJournal | None = None) -> PackedState:
    """Rebuild whole fat rows for node ids `rows` from the current
    adjacency, in place.  Ids outside [0, cap) write the dump row.
    ``journal`` keeps the fat rows first."""
    cap, r_slack = adjacency.shape
    dp = packed.dp
    rp = packed.r_pack
    idw = packed.idw
    nwr = packed.nwr
    rows = torch.as_tensor(rows, device=adjacency.device).long()
    t = rows.shape[0]
    arows = adjacency[rows.clamp(0, cap - 1)]                # [T, Rs]
    safe = arows.long().clamp(0, cap - 1)
    fat = torch.zeros((t, nwr * 128), dtype=torch.int32, device=adjacency.device)
    fat[:, : idw * 128] = -1
    fat[:, :r_slack] = arows
    fat[:, idw * 128 : 2 * idw * 128] = INF_BITS
    aux = torch.where(arows >= 0, packed.self_aux[safe], float("inf"))
    fat[:, idw * 128 : idw * 128 + r_slack] = f32_to_words(aux)
    # alignment pad slots [r_slack, rp) carry node 0's codes, exactly as
    # the reference's clip(-1 -> 0) gather writes them
    code_idx = torch.nn.functional.pad(safe, (0, rp - r_slack))
    code_w = codes_to_words(packed.self_codes[code_idx]).reshape(t, rp * (dp // 4))
    fat[:, 2 * idw * 128 : 2 * idw * 128 + rp * (dp // 4)] = code_w
    w = torch.where((rows >= 0) & (rows < cap), rows, cap)
    if journal is not None:
        journal.save(logical_rows(packed), w)
    nblk = nwr // 8
    gidx = (w[:, None] * nblk + torch.arange(nblk, device=w.device)[None, :])
    block_patch(packed.rows, gidx.reshape(-1).to(torch.int32),
                fat.view(t * nwr, 128))
    return packed


def append_edges(packed: PackedState, tgt, slot, src, ok,
                 journal: RowJournal | None = None) -> PackedState:
    """Splice src's (id, aux, code) into the (tgt, slot) cells, in place —
    the backedge fast path.  Edges with ``ok`` False write the dump row.
    ``journal`` keeps the words of those cells first (a target's whole
    fat row would cost ~nwr*128 words for the 2 + dp/4 it changes).

    The flat word offset of slot s in row t (dpw = dp/4 divides 128):

      id   word: t*nwr*128 + s
      aux  word: t*nwr*128 + idw*128 + s
      code word: t*nwr*128 + 2*idw*128 + s*dpw + k,  k in [0, dpw)
    """
    cap = packed.self_codes.shape[0]
    dpw = packed.dp // 4
    idw = packed.idw
    nwr = packed.nwr
    src_c = src.long().clamp(0, cap - 1)
    code_w = codes_to_words(packed.self_codes[src_c])          # [E, dpw]
    aux_w = f32_to_words(packed.self_aux[src_c])
    slot_s = torch.where(ok, slot, 0).long()
    tgt_s = torch.where(ok, tgt, cap).long()                   # cap = dump row
    base = tgt_s * (nwr * 128)
    flat = packed.rows.view(-1)
    cbase = base + 2 * idw * 128 + slot_s * dpw
    if journal is not None:
        journal.save(flat, base + slot_s)
        journal.save(flat, base + idw * 128 + slot_s)
        # a code's dpw words start at a multiple of dpw (dpw divides 128)
        journal.save(flat.view(-1, dpw), cbase // dpw)
    flat[base + slot_s] = src.to(torch.int32)
    flat[base + idw * 128 + slot_s] = aux_w
    kw = torch.arange(dpw, device=base.device)[None, :]
    flat[cbase[:, None] + kw] = code_w
    return packed


def append_edges_deferred(packed: PackedState, tgt, slot, src, ok, **_legacy) -> PackedState:
    """`append_edges` on array-like edges (converted to the table's device
    first); the reference's name for its donating form, whose update is
    in place here as well."""
    dev = packed.rows.device
    as_t = lambda a, dt: torch.as_tensor(a, device=dev).to(dt)  # noqa: E731
    return append_edges(packed, as_t(tgt, torch.int32), as_t(slot, torch.int32),
                        as_t(src, torch.int32), as_t(ok, torch.bool))
