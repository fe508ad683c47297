"""Distance-preserving transforms: the fast Walsh-Hadamard transform and its
randomized form (PyTorch port of `diskann_tpu/quant/transforms.py`).

The butterfly network is log2(d) elementwise stages, O(d log d) per row
against O(d^2) for a dense rotation; `as_matrix` materializes the
equivalent rotation for callers that want one product.  The randomized
form H*D (diagonal +-1 signs, ``rounds`` repetitions) is the standard
structured rotation.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from diskann_tpu_torch.devices import generator as make_generator


def _next_pow2(d: int) -> int:
    p = 1
    while p < d:
        p <<= 1
    return p


def fwht(x: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
    """Walsh-Hadamard transform along the last axis (power-of-2 length);
    orthonormal and self-inverse when ``normalize``."""
    d = x.shape[-1]
    if d & (d - 1):
        raise ValueError(f"fwht needs a power-of-2 dim, got {d}")
    shape = x.shape
    y = x.float().reshape(-1, d)
    h = 1
    while h < d:
        y = y.reshape(-1, d // (2 * h), 2, h)
        a, b = y[:, :, 0, :], y[:, :, 1, :]
        y = torch.stack([a + b, a - b], dim=2)
        h *= 2
    y = y.reshape(shape)
    if normalize:
        y = y * (1.0 / math.sqrt(d))
    return y


class RandomizedHadamard(NamedTuple):
    """Padded randomized Hadamard rotation x -> FWHT(D_r(...FWHT(D_1 pad(x)))):
    [..., dim] -> [..., dim_pad] (zero pad to the next power of 2, norms
    kept).  ``signs`` is [rounds, dim_pad] of +-1."""

    signs: torch.Tensor
    dim: int

    @property
    def dim_pad(self) -> int:
        return int(self.signs.shape[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.nn.functional.pad(x.float(), (0, self.dim_pad - self.dim))
        for r in range(self.signs.shape[0]):
            x = fwht(x * self.signs[r])
        return x

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        for r in range(self.signs.shape[0] - 1, -1, -1):
            y = fwht(y) * self.signs[r]
        return y[..., : self.dim]

    def as_matrix(self) -> torch.Tensor:
        """The equivalent [dim, dim_pad] rotation (orthonormal rows)."""
        return self.forward(torch.eye(self.dim, device=self.signs.device))


def train_randomized_hadamard(dim: int, *, rounds: int = 2, seed: int = 0,
                              generator: torch.Generator | None = None
                              ) -> RandomizedHadamard:
    """Draw the sign diagonals (the reference's double Hadamard is 2
    rounds) from ``generator`` (its device), or from a new CPU one seeded
    with ``seed``."""
    gen = make_generator(seed, generator)
    dp = _next_pow2(dim)
    coin = torch.rand((rounds, dp), generator=gen, device=gen.device) < 0.5
    return RandomizedHadamard(signs=torch.where(coin, 1.0, -1.0), dim=dim)
