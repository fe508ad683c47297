"""The bf16 router's product, epilogue and top-n_start: kernel K4 of the
port (`csrc/router_topk.cu`).

Replaces no Pallas kernel: the JAX package leaves the bf16 router to XLA
(`diskann_tpu/graph/index.py`, the packed router's product with
``preferred_element_type=bfloat16``), which fuses its epilogue, while eager
PyTorch writes the whole [B, S] bf16 distance block to device memory and
runs a radix top-k over it.  For each query it takes the distances to the
``S`` router rows, in the order and with the roundings of the router's
PyTorch code (`router_topk_plain`):

1. ``dot = bf16(sum_k bf16(qs[b, k]) * bf16(rc[s, k]))``, summed in float32;
2. ``t = bf16(bf16(qsq[b]) + bf16(raux[s]))``;
3. ``d = bf16(t - 2 * dot)``, or ``d = -dot`` for inner product;

then the ``n_start`` smallest ``d`` of each row, exact, ascending by
(distance, column): on equal distances the lower column wins; -0.0 equals
+0.0 and NaN sorts above +inf.  Returns ``router_ids`` of those columns.

`router_topk` launches the CUDA kernel for CUDA tensors and runs
`router_topk_plain` for CPU tensors.  The kernel's float32 sums run in the
tensor cores' order, so on the card a dot may round to the neighbouring
bf16 value where the library's product rounds the other way; that is the
one way the two may differ.  `plan` sizes the kernel's tiles and grid (the
source's note says why); the kernel refuses a plan that does not hold what
it describes.
"""

from __future__ import annotations

import dataclasses

import torch

from diskann_tpu_torch.ops.kernels import native
from diskann_tpu_torch.ops.kernels.fatrow_expand import H100_SMS, SMEM_PER_BLOCK, sm_count

#: The most entry points a query the kernel selects (its longest list).
MAX_N_START = 32
#: The router code widths it takes: the packed layout's (dp/4 divides 128).
MAX_DP = 512
#: The depth of one stage of router codes (a wider dp takes 2 or 4).
STAGE_DEPTH = 128
#: Queries a block (the kernel's 8 product warps hold 32 each, its 4
#: selection warps one a thread) and router rows a tile.
BLOCK_QUERIES = 128
TILE_ROWS = 64
#: The lists' lengths the kernel is built for.
LIST_SIZES = (4, 8, 16, 32)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel runs one call: lists of ``list_size`` entries, the
    router's ``tiles`` of TILE_ROWS rows split over ``splits`` blocks along
    the router rows for each of ``query_tiles`` blocks along the queries,
    and ``smem_bytes`` of dynamic shared memory a block: the bf16 query
    tile (dp rounded up to STAGE_DEPTH), two bf16 stages of one tile's
    codes STAGE_DEPTH deep, two of its bf16 raux and three bf16 distance
    tiles, each row padded by 16 bytes."""

    list_size: int
    tiles: int
    query_tiles: int
    splits: int
    smem_bytes: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _smem_bytes(dp: int) -> int:
    dpp = _round_up(dp, STAGE_DEPTH)
    return (BLOCK_QUERIES * (2 * dpp + 16) + 2 * TILE_ROWS * (2 * STAGE_DEPTH + 16)
            + _round_up(4 * TILE_ROWS, 16) + 3 * BLOCK_QUERIES * (2 * TILE_ROWS + 16))


def plan(b: int, s: int, dp: int, n_start: int, *, n_sms: int = H100_SMS) -> Plan:
    """The kernel's plan for ``b`` queries over ``s`` router rows of width
    ``dp`` at ``n_start`` entry points, on a card of ``n_sms`` SMs: about
    one block an SM (``splits`` = SMs over the query tiles, at most one
    split a tile).  Raises ValueError beyond the kernel's limits."""
    check_limits(s, dp, n_start)
    tiles = -(-s // TILE_ROWS)
    query_tiles = -(-b // BLOCK_QUERIES)
    splits = max(1, min(tiles, n_sms // max(query_tiles, 1)))
    return Plan(next(n for n in LIST_SIZES if n >= min(n_start, s)), tiles, query_tiles,
                splits, _smem_bytes(dp))


def check_limits(s: int, dp: int, n_start: int) -> None:
    """Raise ValueError for a router the kernel does not take: S >= 1 rows,
    dp one of the packed layout's widths (dp/4 divides 128: 4..MAX_DP),
    1 <= n_start <= MAX_N_START."""
    if s < 1:
        raise ValueError("router_topk: the router has no rows")
    if dp < 4 or dp > MAX_DP or dp % 4 or 128 % (dp // 4):
        raise ValueError(f"router_topk: dp={dp} outside the kernel's widths "
                         f"(dp/4 divides 128: 4..{MAX_DP})")
    if not 1 <= n_start <= MAX_N_START:
        raise ValueError(f"router_topk: n_start={n_start} outside the kernel's limit "
                         f"1..{MAX_N_START} (MAX_N_START)")


def router_topk_plain(qs, qsq, rc, raux, router_ids, n_start: int, *,
                      inner_product: bool):
    """Plain PyTorch version: the router's bf16 product and epilogue, then
    an exact smallest ``n_start`` a row by (distance, column).  Same
    output as `router_topk`."""
    dots = qs.bfloat16() @ rc.bfloat16().T
    if inner_product:
        d = -dots
    else:
        d = qsq[:, None].bfloat16() + raux[None, :].bfloat16() - 2.0 * dots
    # + 0.0 folds -0.0 into +0.0; the stable sort keeps lower columns first
    top = torch.sort(d + 0.0, dim=1, stable=True).indices[:, :min(n_start, d.shape[1])]
    return router_ids[top]


def router_topk(qs, qsq, rc, raux, router_ids, n_start: int, *, inner_product: bool):
    """Each query's ``n_start`` nearest router ids: qs [B, dp] float32 (the
    scaled queries of `graph/scorers.quantize_queries`), qsq [B] float32
    (the centred queries' squared norms; None for inner product), rc [S, dp]
    int8 router codes, raux [S] float32, router_ids [S] int32.  Returns
    [B, min(n_start, S)] int32.  Raises ValueError for an n_start below 1,
    and for CUDA tensors beyond the kernel's limits (`check_limits`:
    n_start at most MAX_N_START); the plain version on the CPU has no
    other limit."""
    b, dp = (qs.shape if qs.dim() == 2 else (-1, -1))
    s = rc.shape[0] if rc.dim() == 2 else -1
    if qs.dim() != 2 or rc.dim() != 2 or rc.shape[1] != dp:
        raise ValueError(f"router_topk: qs {tuple(qs.shape)} and rc {tuple(rc.shape)} "
                         f"are not [B, dp] and [S, dp]")
    if n_start < 1:
        raise ValueError(f"router_topk: n_start={n_start} below 1")
    if inner_product:
        qsq = None
    elif qsq is None:
        raise ValueError("router_topk: the L2 form needs qsq")
    for name, t, dt, shape in (
        ("qs", qs, torch.float32, (b, dp)),
        ("qsq", qsq, torch.float32, (b,)),
        ("rc", rc, torch.int8, (s, dp)),
        ("raux", raux, torch.float32, (s,)),
        ("router_ids", router_ids, torch.int32, (s,)),
    ):
        if t is None:
            continue
        if t.device != qs.device:
            raise ValueError(f"router_topk: {name} on {t.device}, qs on {qs.device}")
        if t.dtype != dt:
            raise ValueError(f"router_topk: {name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"router_topk: {name} shape {tuple(t.shape)} != {shape}")
    dev = qs.device
    if dev.type == "cpu":
        return router_topk_plain(qs, qsq, rc, raux, router_ids, n_start,
                                 inner_product=inner_product)
    if dev.type != "cuda":
        raise ValueError(f"router_topk: unsupported device {dev}")
    check_limits(s, dp, n_start)
    for name, t in (("qs", qs), ("qsq", qsq), ("rc", rc), ("raux", raux),
                    ("router_ids", router_ids)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"router_topk: {name} must be contiguous")
    if qs.data_ptr() % 16 or rc.data_ptr() % 16:
        raise ValueError("router_topk: qs and rc must be 16-byte aligned")
    n_out = min(n_start, s)
    out = torch.empty((b, n_out), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    p = plan(b, s, dp, n_start, n_sms=sm_count(index))
    if p.query_tiles > 65535:
        raise ValueError(f"router_topk: B={b} exceeds the kernel's "
                         f"{65535 * BLOCK_QUERIES} queries a call")
    cand = torch.empty((b, p.splits, p.list_size), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = native.library().router_topk_launch(
            qs.data_ptr(), qsq.data_ptr() if qsq is not None else None, rc.data_ptr(),
            raux.data_ptr(), router_ids.data_ptr(), cand.data_ptr(), out.data_ptr(),
            b, s, dp, n_out, int(inner_product), p.list_size, p.splits, p.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    native.check(err, "router_topk")
    # one count a call: the product and selection, then the merge of the
    # splits' lists
    native.count("router_topk")
    return out


def rounding_disagreements(got, want, qs, qsq, rc, raux, router_ids, n_start: int, *,
                           inner_product: bool) -> tuple[list[int], list[int]]:
    """The queries where `router_topk`'s ids ``got`` differ from
    `router_topk_plain`'s ``want`` (same arguments): (those a rounding of
    the dots explains, the rest).  A difference is explained where the
    ids of ``got`` are distinct router ids and each could be among the
    ``n_start`` nearest once every dot may take a neighbouring bf16 value:
    its least distance so is at most the n_start-th smallest of every
    column's largest."""
    rows = torch.nonzero((got != want).any(1)).flatten().tolist()
    if not rows:
        return [], []
    col_of = torch.full((int(router_ids.max()) + 1,), -1, dtype=torch.long,
                        device=router_ids.device)
    col_of[router_ids.long()] = torch.arange(router_ids.shape[0], device=router_ids.device)
    t = None if inner_product else qsq[rows].bfloat16()[:, None] + raux.bfloat16()[None, :]
    dot = (qs[rows].bfloat16() @ rc.bfloat16().T) + 0.0
    bits = dot.view(torch.int16).int()
    neg = bits < 0
    up = torch.where(neg, bits - 1, bits + 1)
    down = torch.where(bits == 0, -32767, torch.where(neg, bits + 1, bits - 1))

    def dist(b):
        d = b.to(torch.int16).view(torch.bfloat16)
        return (-d if inner_product else t - 2.0 * d).float()

    lo = torch.minimum(dist(up), dist(down))
    hi = torch.maximum(dist(up), dist(down))
    bound = torch.sort(hi, dim=1).values[:, min(n_start, hi.shape[1]) - 1]
    ok, bad = [], []
    for j, r in enumerate(rows):
        ids = got[r].long()
        cols = col_of[ids.clamp(0, col_of.shape[0] - 1)]
        fine = (bool((ids >= 0).all()) and bool((ids < col_of.shape[0]).all())
                and bool((cols >= 0).all()) and len(set(cols.tolist())) == len(cols)
                and bool((lo[j, cols.clamp_min(0)] <= bound[j]).all()))
        (ok if fine else bad).append(r)
    return ok, bad
