"""Fused fat-row expand: kernel K1 of the port (`csrc/fatrow_expand.cu`).

Replaces the Pallas kernel `diskann_tpu/ops/kernels/fatrow_expand.py`.  For
each beam slot it fetches the node's fat row from the int32 word table
(`graph/packed.py` layout), copies out the id and aux sections, and takes
the int32 dot of every neighbour's int8 code with the slot's int8 query.

`fatrow_expand` launches the CUDA kernel for CUDA tensors and runs
`fatrow_expand_plain` for CPU tensors.  The plain version is the
reference the kernel is checked against.  `plan` sizes the kernel's ring
of shared-memory stages and its persistent grid (the source's note says
why); the kernel refuses a plan that does not hold what it describes.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import torch

from diskann_tpu_torch.graph.packed import code_wrows, id_wrows, n_wrows
from diskann_tpu_torch.ops.kernels import native

#: Kernel launches so far in this process (the wrapper adds one per launch),
#: in all, per CUDA device index and per dp; the counts move under a lock,
#: since a server's threads may launch at once.
launches = 0
launches_by_device: dict[int, int] = {}
launches_by_dp: dict[int, int] = {}
_count_lock = threading.Lock()

#: The most shared memory one block may take on sm_90 (227 KB).
SMEM_PER_BLOCK = 232_448
#: SMs of an H100 SXM, the plan's default when no device is named.
H100_SMS = 132
#: Whole slots share a stage up to about this many bytes of prefix.
STAGE_TARGET = 8192
#: The ring a block keeps in flight, in bytes (at least two stages).
RING_TARGET = 131_072
#: Warps a block at most (the kernel takes 1-16): each copies in and scores
#: its own stages.
WARPS = 12
#: Slots a stage at most: one lane each issues their copies.
MAX_SLOTS_PER_STAGE = 32


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel runs one call.  Stage ``k`` of the ring starts at
    byte ``k * stage_stride`` of the block's dynamic shared memory: the
    ``slots_per_stage`` fat-row prefixes (``stage_bytes``, what the
    stage's bulk copies bring), then the slots' queries and their dots,
    each rounded up to 16 bytes; an 8-byte mbarrier a stage follows the
    ring.  The stride is a multiple of 128 bytes: the bulk copies run
    slower into stages aligned to 16 bytes only.  ``warps`` divides
    ``stages``: each warp owns stages / warps of them."""

    slots_per_stage: int
    stages: int
    warps: int
    grid: int
    prefix_bytes: int
    stage_bytes: int
    stage_stride: int
    smem_bytes: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan(rp: int, dp: int, bw: int, *, n_sms: int = H100_SMS) -> Plan:
    """The kernel's plan for ``bw`` slots at (rp, dp) on a card of ``n_sms``
    SMs: whole prefixes under STAGE_TARGET bytes share a stage, the ring
    holds about RING_TARGET bytes (at least two stages where two fit, else
    one) in a multiple of its warps (at most WARPS), and one persistent
    block runs on each SM, none without a group of slots.  Raises for a dp
    that `_geometry` rejects and for a prefix too wide for one stage."""
    idw, _, codr, cpr = _geometry(rp, dp)
    prefix = (2 * idw + codr) * 512
    sps = max(1, min(STAGE_TARGET // prefix, MAX_SLOTS_PER_STAGE, bw))
    stride = _round_up(sps * prefix + _round_up(sps * dp, 16)
                       + _round_up(sps * codr * cpr * 4, 16), 128)
    fit = SMEM_PER_BLOCK // (stride + 8)
    if fit < 1:
        raise ValueError(f"fatrow_expand: a {prefix}-byte fat-row prefix (rp={rp}, "
                         f"dp={dp}) exceeds one block's shared memory")
    want = max(2, -(-RING_TARGET // (sps * prefix)))
    warps = min(WARPS, want, fit)
    stages = -(-want // warps) * warps
    if stages > fit:
        stages = fit // warps * warps
    grid = max(1, min(-(-bw // sps), n_sms))
    return Plan(slots_per_stage=sps, stages=stages, warps=warps,
                grid=grid, prefix_bytes=prefix, stage_bytes=sps * prefix,
                stage_stride=stride, smem_bytes=stages * (stride + 8))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _geometry(rp: int, dp: int):
    dpw = dp // 4
    if dp % 4 or dpw < 1 or 128 % dpw:
        raise ValueError(f"dp={dp}: dp/4 must divide 128")
    return id_wrows(rp), n_wrows(rp, dp), code_wrows(rp, dp), 128 // dpw


def fatrow_expand_plain(rows, beam_flat, qiw, *, rp: int, dp: int):
    """Plain PyTorch version: gather the fat rows, view the code words as
    int8, int32 multiply-sum.  Same outputs as `fatrow_expand`."""
    idw, nwr, codr, cpr = _geometry(rp, dp)
    n = rows.shape[0] // nwr
    bw = beam_flat.shape[0]
    safe = beam_flat.long().clamp(0, n - 1)
    fat = rows.reshape(n, nwr * 128)[safe]                  # [BW, nwr*128]
    ids = fat[:, : idw * 128]
    aux_w = fat[:, idw * 128 : 2 * idw * 128]
    words = fat[:, 2 * idw * 128 : (2 * idw + codr) * 128].contiguous()
    codes = words.view(torch.int8).reshape(bw, codr * cpr, dp).int()
    dots = (codes * qiw.int()[:, None, :]).sum(-1, dtype=torch.int32)
    return ids.contiguous(), aux_w.contiguous(), dots


def fatrow_expand(rows, beam_flat, qiw, *, rp: int, dp: int):
    """rows [(cap+1)*nwr, 128] int32 word table; beam_flat [BW] int32 node
    ids (clamped to the table); qiw [BW, dp] int8 query codes per beam slot.

    Returns (ids [BW, idw*128] int32, aux_w [BW, idw*128] int32 holding
    float32 bits, dots [BW, codr*cpr] int32 in neighbour-slot order)."""
    global launches
    if rows.device.type == "cpu":
        return fatrow_expand_plain(rows, beam_flat, qiw, rp=rp, dp=dp)
    if rows.device.type != "cuda":
        raise ValueError(f"fatrow_expand: unsupported device {rows.device}")
    idw, nwr, codr, cpr = _geometry(rp, dp)
    bw = beam_flat.shape[0]
    for name, t, dt, shape in (
        ("rows", rows, torch.int32, None),
        ("beam_flat", beam_flat, torch.int32, (bw,)),
        ("qiw", qiw, torch.int8, (bw, dp)),
    ):
        if t.device != rows.device:
            raise ValueError(f"fatrow_expand: {name} on {t.device}, rows on {rows.device}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"fatrow_expand: {name} must be contiguous {dt}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"fatrow_expand: {name} shape {tuple(t.shape)} != {shape}")
    if rows.dim() != 2 or rows.shape[1] != 128 or rows.shape[0] % nwr:
        raise ValueError(
            f"fatrow_expand: rows shape {tuple(rows.shape)} is not [n*{nwr}, 128]"
        )
    if rows.data_ptr() % 16 or qiw.data_ptr() % min(dp, 16):
        raise ValueError("fatrow_expand: rows must be 16-byte aligned, and qiw "
                         "aligned to min(dp, 16) bytes")
    dev = rows.device
    ids = torch.empty((bw, idw * 128), dtype=torch.int32, device=dev)
    aux_w = torch.empty((bw, idw * 128), dtype=torch.int32, device=dev)
    dots = torch.empty((bw, codr * cpr), dtype=torch.int32, device=dev)
    if bw == 0:
        return ids, aux_w, dots
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    p = plan(rp, dp, bw, n_sms=sm_count(index))
    with torch.cuda.device(dev):
        err = native.library().fatrow_expand_launch(
            rows.data_ptr(), rows.shape[0] // nwr, beam_flat.data_ptr(),
            qiw.data_ptr(), bw, rp, dp, p.slots_per_stage, p.stages,
            p.warps, p.grid, p.stage_stride, p.smem_bytes,
            ids.data_ptr(), aux_w.data_ptr(), dots.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    native.check(err, "fatrow_expand")
    with _count_lock:
        launches += 1
        launches_by_device[dev.index] = launches_by_device.get(dev.index, 0) + 1
        launches_by_dp[dp] = launches_by_dp.get(dp, 0) + 1
    return ids, aux_w, dots
