"""Bit-sliced packed codes: 1/2/4/8 bits per dimension in 32-bit words
(PyTorch port of `diskann_tpu/quant/bits.py`).

Layout: codes [N, d] with values < 2^b pack into words [N, ceil(d*b/32)],
dimension-major within a word (dim j sits at bit (j % (32/b)) * b of word
j // (32/b)).

Torch has no shifts and no popcount on ``uint32``, so the words are held as
``torch.int32`` with the reference's uint32 bit patterns (its words viewed
as int32).  Packing builds each word in int64, where the disjoint fields
sum without overflow, then narrows; unpacking masks every arithmetic right
shift, which discards the sign fill; popcounts are a SWAR count in int64.
"""

from __future__ import annotations

import torch

VALID_BITS = (1, 2, 4, 8)

_M32 = 0xFFFFFFFF


def words_per_row(dim: int, n_bits: int) -> int:
    per = 32 // n_bits
    return -(-dim // per)


def _check_bits(n_bits: int) -> None:
    if n_bits not in VALID_BITS:
        raise ValueError(f"n_bits must be one of {VALID_BITS}, got {n_bits}")


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """Values in [0, 2^32) (int64) -> int32 with the same 32 bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_bits(codes: torch.Tensor, n_bits: int) -> torch.Tensor:
    """[..., d] integer codes (< 2^n_bits) -> [..., W] int32 words."""
    _check_bits(n_bits)
    d = codes.shape[-1]
    per = 32 // n_bits
    w = words_per_row(d, n_bits)
    c = codes.long() & ((1 << n_bits) - 1)
    c = torch.nn.functional.pad(c, (0, w * per - d))
    c = c.reshape(c.shape[:-1] + (w, per))
    shifts = torch.arange(per, device=c.device) * n_bits
    return _to_int32((c << shifts).sum(-1))


def unpack_bits(words: torch.Tensor, n_bits: int, dim: int) -> torch.Tensor:
    """[..., W] int32 words -> [..., dim] int32 codes."""
    _check_bits(n_bits)
    per = 32 // n_bits
    shifts = torch.arange(per, dtype=torch.int32, device=words.device) * n_bits
    c = (words.to(torch.int32)[..., None] >> shifts) & ((1 << n_bits) - 1)
    c = c.reshape(words.shape[:-1] + (words.shape[-1] * per,))
    return c[..., :dim]


def dot_packed(q: torch.Tensor, words: torch.Tensor, n_bits: int,
               dim: int) -> torch.Tensor:
    """Asymmetric dot of float32 query rows with packed code rows.

    q: [B, dim]; words: [..., W] (any leading shape).  Returns [B, ...]
    float32 <q, codes> with the codes as raw ints 0..2^b-1 (callers fold
    their affine decode into per-row constants)."""
    codes = unpack_bits(words, n_bits, dim).float()
    out = q.float() @ codes.reshape(-1, dim).T
    return out.reshape((q.shape[0],) + tuple(words.shape[:-1]))


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 or int64 holding 32 bits), as
    int64: a SWAR count in int64."""
    x = x.long() & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def hamming_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric 1-bit distance: [M, W] x [N, W] -> [M, N] int32 popcounts."""
    x = torch.bitwise_xor(a[:, None, :], b[None, :, :])
    return _popcount32(x).sum(-1).to(torch.int32)
