"""The packed list walk's hop tail: kernel K3 of the port
(`csrc/hop_merge.cu`).

Replaces no Pallas kernel: the JAX package leaves this step to XLA, which
fuses it into the jitted hop, while eager PyTorch issues it as ~90 small
launches a hop, and at one query a request the host's cost of those
launches, not the card, sets the walk's time.  After K1 (`fatrow_expand`)
has read the beam's fat rows, `hop_merge` does the rest of one hop of the
packed list walk (`graph/search.beam_search_scored_steps` with
``dedup="list"``) in one launch, in place on the walk's `HopState`:

1. each candidate's distance from K1's ids, aux words and int32 dots
   (`candidates`, the packed scorer's epilogue);
2. in-hop dedup: the first copy of each id in slot-major order;
3. list dedup: ids the row's best list already holds;
4. the merge: the L smallest of [best list, fresh candidates in id order]
   by (distance, position), with the expanded bits; the fresh count added
   to ``cmps`` and the expanded count to ``hops``;
5. the next hop's frontier (`frontier`): the first W unexpanded entries,
   marked expanded, as the next beam, and the flag "any entry left
   unexpanded" that the walk yields.

`hop_merge` launches the CUDA kernel for CUDA tensors and runs
`hop_merge_plain`, the walk's PyTorch code, for CPU tensors; the plain
version is the reference the kernel is checked against, bitwise.  The
kernel's byte bound and how its design stands against it are in the
source's note.
"""

from __future__ import annotations

import dataclasses

import torch

from diskann_tpu_torch.graph.packed import words_to_f32
from diskann_tpu_torch.ops.kernels import native
from diskann_tpu_torch.ops.kernels.fatrow_expand import SMEM_PER_BLOCK
from diskann_tpu_torch.ops.topk import (
    SENTINEL, isin_rows, mask_duplicates_sorted, sort_with,
)

#: Threads a block at most (a quarter of the candidates' power of two).
MAX_THREADS = 512


@dataclasses.dataclass
class HopState:
    """The packed list walk between two hops, updated in place by
    `hop_merge`.  ``beam`` holds the hop's expanded ids (-1 where a row
    has fewer than W unexpanded entries; its [B*W] view is K1's beam,
    which K1 clamps to the table); every hop gets a new one, so a caller
    that kept a hop's beam keeps what that hop expanded.  Hop ``h`` sets
    ``flags[h % 2]`` when any row has an entry left unexpanded and clears
    the other, which hop ``h + 1`` sets."""

    best_d: torch.Tensor   # [B, L] f32 ascending
    best_i: torch.Tensor   # [B, L] i32 (-1 pad)
    best_e: torch.Tensor   # [B, L] i32 expanded flags
    cmps: torch.Tensor     # [B] i32
    hops: torch.Tensor     # [B] i32
    beam: torch.Tensor     # [B, W] i32
    flags: torch.Tensor    # [2] bool

    def clone(self) -> "HopState":
        return HopState(*(getattr(self, f.name).clone() for f in dataclasses.fields(self)))


def frontier(best_i, best_e, w: int, active=None):
    """Step 1 of a list-walk hop (every walk of `graph/search.py` takes it
    from here): the first ``w`` unexpanded entries of each row, among the
    ``active`` [B, L] positions where given.  Returns (flag: any such
    entry, sel_pos [B, min(w, L)] their positions (L past a row's last),
    beam [B, min(w, L)] i32 their ids (-1 there), best_e with them marked
    expanded)."""
    b, l = best_i.shape
    unexp = (best_e == 0) & (best_i >= 0)
    if active is not None:
        unexp &= active
    rank = unexp.cumsum(1) - 1
    sel = unexp & (rank < w)
    pos = torch.arange(l, device=best_i.device).expand(b, l)
    sel_pos = torch.sort(torch.where(sel, pos, l), dim=1).values[:, :w]
    beam = torch.where(sel_pos < l, best_i.gather(1, sel_pos.clamp_max(l - 1)), -1)
    return unexp.any(), sel_pos, beam, torch.where(sel, 1, best_e)


def start(best_d, best_i, best_e, cmps, hops, w: int):
    """The walk's state before its first hop, and the first hop's flag."""
    flag, _, beam, best_e = frontier(best_i, best_e, w)
    st = HopState(best_d.contiguous(), best_i.contiguous(), best_e.contiguous(),
                  cmps.contiguous(), hops.contiguous(), beam.contiguous(),
                  torch.zeros(2, dtype=torch.bool, device=best_d.device))
    return st, flag


def candidates(ids_w, aux_w, dots, qscale, qsq, beam_valid, *, rp: int,
               inner_product: bool):
    """The packed scorer's epilogue to K1: [B, W*rp] candidate ids (-1 for
    an invalid beam slot or an empty neighbour slot) and their float32
    distances (inf there): the negated dot for inner product, else
    max(qsq + aux - 2 * dot, 0), each dot the int32 one times the query's
    scale."""
    b, w = beam_valid.shape
    cand = ids_w[:, :rp].reshape(b, w * rp)
    aux = words_to_f32(aux_w[:, :rp]).reshape(b, w * rp)
    dts = dots[:, :rp].reshape(b, w * rp).float() * qscale[:, None]
    cand = torch.where(beam_valid.view(b, w, 1), cand.view(b, w, rp), -1).view(b, w * rp)
    if inner_product:
        d = -dts
    else:
        d = (qsq[:, None] + aux - 2.0 * dts).clamp_min(0.0)
    return cand, torch.where(cand >= 0, d, float("inf"))


def hop_merge_plain(ids_w, aux_w, dots, qscale, qsq, st: HopState, hop: int, *,
                    rp: int, inner_product: bool) -> None:
    """Plain PyTorch version: the walk's steps 2-5 (`graph/search.py`)
    after the packed scorer's epilogue, then the next frontier.  Same
    effect on ``st`` as `hop_merge`."""
    b, w = st.beam.shape
    l = st.best_d.shape[1]
    beam_valid = st.beam >= 0
    ci, cd = candidates(ids_w, aux_w, dots, qscale, qsq, beam_valid, rp=rp,
                        inner_product=inner_product)
    # every neighbour, sorted by id; then the hop's and the list's repeats out
    cand = torch.where(ci >= 0, ci, SENTINEL)
    cand, cand_d = sort_with(cand, cd)
    fresh = ((cand != SENTINEL) & ~mask_duplicates_sorted(cand)
             & ~isin_rows(cand, st.best_i))
    cd = torch.where(fresh, cand_d, float("inf"))
    cand_ids = torch.where(fresh, cand, -1)
    st.cmps += fresh.sum(1, dtype=torch.int32)
    st.hops += beam_valid.sum(1, dtype=torch.int32)
    # merge into the best lists: (id, expanded) in one word
    md, key = sort_with(torch.cat([st.best_d, cd], 1),
                        torch.cat([st.best_i * 2 + st.best_e,
                                   torch.where(cand_ids >= 0, cand_ids * 2, -1)], 1))
    flag, _, beam, best_e = frontier(key[:, :l] >> 1, key[:, :l] & 1, w)
    st.best_d.copy_(md[:, :l])
    st.best_i.copy_(key[:, :l] >> 1)
    st.best_e.copy_(best_e)
    st.beam = beam.contiguous()
    st.flags[hop % 2] = flag
    st.flags[(hop + 1) % 2] = False


def geometry(c: int, l: int, w: int) -> tuple[int, int, int]:
    """(threads, hash table log2 slots, dynamic shared bytes) of a block at
    ``c`` = W * r_pack candidates, list width ``l`` and beam width ``w``:
    the sort's keys (next power of two of c, 8 bytes each), a hash table of
    at least twice the c + l ids it may hold (8 bytes a slot), two words a
    candidate, seven a list entry, one a beam slot and four counts."""
    p = 1 << max(c - 1, 0).bit_length()
    threads = min(MAX_THREADS, max(32, p // 4))
    hbits = (2 * (c + l) - 1).bit_length()
    smem = 8 * p + 8 * (1 << hbits) + 8 * c + 28 * l + 4 * w + 16
    return threads, hbits, -(-smem // 16) * 16


def fits(c: int, l: int, w: int) -> bool:
    """Whether one block holds a row of this geometry (the walk takes its
    generic body where it does not)."""
    return geometry(c, l, w)[2] <= SMEM_PER_BLOCK


def hop_merge(ids_w, aux_w, dots, qscale, qsq, st: HopState, hop: int, *,
              rp: int, inner_product: bool) -> None:
    """One hop tail of the packed list walk, in place on ``st``: ids_w /
    aux_w [B*W, >= rp] int32 and dots [B*W, >= rp] int32 are K1's outputs
    for ``st.beam``; qscale, qsq [B] float32 each query's scale and squared
    norm (`graph/scorers.quantize_queries`); ``hop`` numbers the hop."""
    if st.best_d.device.type == "cpu":
        return hop_merge_plain(ids_w, aux_w, dots, qscale, qsq, st, hop, rp=rp,
                               inner_product=inner_product)
    dev = st.best_d.device
    if dev.type != "cuda":
        raise ValueError(f"hop_merge: unsupported device {dev}")
    b, l = st.best_d.shape
    w = st.beam.shape[1] if st.beam.dim() == 2 else -1
    for name, t, dt, shape in (
        ("ids_w", ids_w, torch.int32, (b * w, ids_w.shape[-1])),
        ("aux_w", aux_w, torch.int32, tuple(ids_w.shape)),
        ("dots", dots, torch.int32, (b * w, dots.shape[-1])),
        ("qscale", qscale, torch.float32, (b,)),
        ("qsq", qsq, torch.float32, (b,)),
        ("best_d", st.best_d, torch.float32, (b, l)),
        ("best_i", st.best_i, torch.int32, (b, l)),
        ("best_e", st.best_e, torch.int32, (b, l)),
        ("cmps", st.cmps, torch.int32, (b,)),
        ("hops", st.hops, torch.int32, (b,)),
        ("beam", st.beam, torch.int32, (b, w)),
        ("flags", st.flags, torch.bool, (2,)),
    ):
        if t.device != dev:
            raise ValueError(f"hop_merge: {name} on {t.device}, best_d on {dev}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"hop_merge: {name} must be contiguous {dt}")
        if tuple(t.shape) != shape:
            raise ValueError(f"hop_merge: {name} shape {tuple(t.shape)} != {shape}")
    if ids_w.shape[-1] < rp or dots.shape[-1] < rp or rp < 1:
        raise ValueError(f"hop_merge: K1's outputs hold fewer than rp={rp} slots")
    if not 1 <= w <= l:
        raise ValueError(f"hop_merge: beam width {w} outside [1, L={l}]")
    if not fits(w * rp, l, w):
        raise ValueError(f"hop_merge: W*rp={w * rp} candidates and L={l} exceed "
                         f"one block's shared memory")
    beam_out = torch.empty_like(st.beam)
    if b == 0:
        st.beam = beam_out
        return
    threads, hbits, smem = geometry(w * rp, l, w)
    with torch.cuda.device(dev):
        err = native.library().hop_merge_launch(
            ids_w.data_ptr(), aux_w.data_ptr(), dots.data_ptr(), qscale.data_ptr(),
            qsq.data_ptr(), st.beam.data_ptr(), beam_out.data_ptr(),
            st.best_d.data_ptr(), st.best_i.data_ptr(), st.best_e.data_ptr(),
            st.cmps.data_ptr(), st.hops.data_ptr(),
            st.flags.data_ptr() + hop % 2, st.flags.data_ptr() + (hop + 1) % 2,
            b, w, rp, l, ids_w.shape[-1], dots.shape[-1], int(inner_product),
            threads, hbits, smem, torch.cuda.current_stream(dev).cuda_stream,
        )
    native.check(err, "hop_merge")
    native.count("hop_merge")
    st.beam = beam_out
