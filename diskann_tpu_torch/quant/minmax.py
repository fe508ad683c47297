"""MinMax quantizer: per-vector, training-free uniform quantization (PyTorch
port of `diskann_tpu/quant/minmax.py`).

Each vector keeps its own (min, step) and 8-bit codes over that range, so
no training pass stands between a new vector and its code."""

from __future__ import annotations

from typing import NamedTuple

import torch


class MinMaxQuantizer(NamedTuple):
    n_bits: int = 8

    @property
    def levels(self) -> int:
        return (1 << self.n_bits) - 1

    def encode(self, data: torch.Tensor):
        """Returns (codes [N, d] uint8, lo [N] f32, step [N] f32)."""
        x = data.float()
        lo = x.amin(1)
        hi = x.amax(1)
        step = (hi - lo).clamp_min(1e-12) / self.levels
        codes = torch.round((x - lo[:, None]) / step[:, None]).clamp(0, self.levels)
        return codes.to(torch.uint8), lo, step

    def decode(self, codes, lo, step):
        return codes.float() * step[:, None] + lo[:, None]
