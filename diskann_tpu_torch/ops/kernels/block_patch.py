"""In-place block patching of a 128-wide table: kernel K2 of the port
(`csrc/block_patch.cu`).

Replaces the Pallas kernel `diskann_tpu/ops/kernels/block_patch.py`: copy G
blocks of 8 rows x 128 elements from ``vals [G*8, 128]`` into ``table`` at
8-row block indices ``block_idx [G]``, in place, for any element type.
Block indices outside the table are skipped.  Duplicate indices must carry
identical values, except at the table's dump block, whose contents are
garbage by design.

`block_patch` launches the CUDA kernel for CUDA tensors and runs
`block_patch_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from diskann_tpu_torch.ops.kernels import native

def block_patch_plain(table, block_idx, vals):
    """Plain PyTorch version: a row `index_copy_` of the valid blocks."""
    nblk = table.shape[0] // 8
    ok = (block_idx >= 0) & (block_idx < nblk)
    rows = (block_idx.long()[:, None] * 8
            + torch.arange(8, device=table.device)[None, :]).reshape(-1)
    keep = ok.repeat_interleave(8)
    table.index_copy_(0, rows[keep], vals[keep])
    return table


def block_patch(table, block_idx, vals):
    """table [R, 128] (R % 8 == 0), patched in place and returned;
    block_idx [G] int32; vals [G*8, 128] of the table's dtype."""
    if table.device.type == "cpu":
        return block_patch_plain(table, block_idx, vals)
    if table.device.type != "cuda":
        raise ValueError(f"block_patch: unsupported device {table.device}")
    g = block_idx.shape[0]
    if table.dim() != 2 or table.shape[1] != 128 or table.shape[0] % 8:
        raise ValueError(f"block_patch: table shape {tuple(table.shape)} is not [8k, 128]")
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("block_patch: table must be contiguous and 16-byte aligned")
    if block_idx.dtype != torch.int32 or block_idx.dim() != 1 or not block_idx.is_contiguous():
        raise ValueError("block_patch: block_idx must be a contiguous [G] int32")
    if (vals.dtype != table.dtype or tuple(vals.shape) != (g * 8, 128)
            or not vals.is_contiguous() or vals.data_ptr() % 16):
        raise ValueError(
            f"block_patch: vals must be a contiguous [{g * 8}, 128] {table.dtype}"
        )
    for name, t in (("block_idx", block_idx), ("vals", vals)):
        if t.device != table.device:
            raise ValueError(f"block_patch: {name} on {t.device}, table on {table.device}")
    if g == 0:
        return table
    with torch.cuda.device(table.device):
        err = native.library().block_patch_launch(
            table.data_ptr(), table.shape[0] // 8, block_idx.data_ptr(),
            vals.data_ptr(), g, 8 * 128 * table.element_size(),
            torch.cuda.current_stream(table.device).cuda_stream,
        )
    native.check(err, "block_patch")
    native.count("block_patch")
    return table
