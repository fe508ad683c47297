"""Scalar quantizer: per-dimension affine int8 compression (PyTorch port of
`diskann_tpu/quant/scalar.py`).

The range of each dimension is mean +/- sigma * std over the training
data (the population std, as the reference's ``jnp.std``), cut into
2^n_bits - 1 steps."""

from __future__ import annotations

from typing import NamedTuple

import torch


class ScalarQuantizer(NamedTuple):
    """codes = round((x - bias) / scale) per dimension, clipped to n_bits."""

    scale: torch.Tensor   # [d] f32
    bias: torch.Tensor    # [d] f32
    n_bits: int

    @property
    def levels(self) -> int:
        return (1 << self.n_bits) - 1

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        """[N, d] -> [N, d] uint8 codes."""
        x = (data.float() - self.bias[None, :]) / self.scale[None, :]
        return torch.round(x).clamp(0, self.levels).to(torch.uint8)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return codes.float() * self.scale[None, :] + self.bias[None, :]


def train_scalar(data, *, n_bits: int = 8, sigma: float = 2.0) -> ScalarQuantizer:
    """Per-dimension range mean +/- sigma * std (sigma clipping), on the
    data's device."""
    data = torch.as_tensor(data, dtype=torch.float32)
    mean = data.mean(0)
    std = data.std(0, correction=0)
    lo = mean - sigma * std
    hi = mean + sigma * std
    scale = (hi - lo).clamp_min(1e-12) / ((1 << n_bits) - 1)
    return ScalarQuantizer(scale=scale, bias=lo, n_bits=n_bits)
