"""Binary quantizer: sign bits and Hamming distance (PyTorch port of
`diskann_tpu/quant/binary.py`).

Codes pack 32 dimensions per word (bit j % 32 of word j // 32 is set where
x_j >= 0), held as int32 with the reference's uint32 bit patterns; the
Hamming distance is XOR plus a popcount summed over words."""

from __future__ import annotations

from typing import NamedTuple

import torch

from diskann_tpu_torch.quant.bits import hamming_packed, pack_bits


class BinaryQuantizer(NamedTuple):
    dim: int

    @property
    def words(self) -> int:
        return -(-self.dim // 32)

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        """[N, d] -> [N, words] int32 sign bits."""
        return pack_bits((data[:, : self.dim] >= 0).to(torch.int64), 1)

    def hamming(self, a_codes: torch.Tensor, b_codes: torch.Tensor) -> torch.Tensor:
        """Pairwise Hamming distances: [M, W] x [N, W] -> [M, N] int32."""
        return hamming_packed(a_codes, b_codes)
