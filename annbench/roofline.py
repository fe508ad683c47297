"""The table of peaks and the bytes and operations of the port's two
kernels, worked out from each call's arguments.

A roofline share is the least time the card could take for the calls,
the larger of bytes over peak bandwidth and operations over peak rate,
summed over the calls, divided by the kernels' measured device time.
Bytes count each input byte read once and each output byte written once,
as these inputs need them: a node's fat row once however many beam slots
name it, a table block once however many patches aim at it.
"""

from __future__ import annotations

import torch

# NVIDIA's data sheet, SXM part, dense rates, at the full 700 W
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "int8_ops_per_s": 1.979e15},
}


def k1_geometry(rp: int, dp: int) -> tuple[int, int, int]:
    """(id word rows, code word rows, codes a word row) of a fat row of
    ``rp`` slots at ``dp`` code bytes; a word row is 128 int32 words."""
    return -(-rp // 128), -(-rp * dp // 512), 512 // dp


def k1_bound(beam: torch.Tensor, table_rows: int, rp: int, dp: int) -> tuple[float, float]:
    """(bytes, int8 operations) that one `fatrow_expand` call needs: the fat
    rows of the distinct beam nodes (ids clamped to the table, as the
    kernel reads them) read once, the beam ids and int8 query codes read
    once, the ids, aux words and dot products written once; one
    multiply-add (two operations) per code byte of every beam slot."""
    idw, codr, cpr = k1_geometry(rp, dp)
    nwr = 2 * idw + codr
    n = table_rows // nwr
    bw = beam.shape[0]
    nodes = int(beam.long().clamp(0, n - 1).unique().numel())
    moved = (nodes * nwr * 512 + bw * (4 + dp)
             + bw * (2 * idw * 128 + codr * cpr) * 4)
    return float(moved), float(2 * bw * codr * cpr * dp)


def k2_bound(block_idx: torch.Tensor, n_blocks: int, block_bytes: int) -> float:
    """Bytes one `block_patch` call needs: each distinct in-range target
    block's new values read once and the block written once, and the
    block indices read once."""
    ok = block_idx[(block_idx >= 0) & (block_idx < n_blocks)]
    return float(2 * int(ok.unique().numel()) * block_bytes + 4 * block_idx.shape[0])


def least_seconds(bytes_: float, ops: float, peak: dict) -> float:
    return max(bytes_ / peak["hbm_bytes_per_s"], ops / peak["int8_ops_per_s"])
