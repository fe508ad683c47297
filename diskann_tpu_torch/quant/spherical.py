"""Spherical (RaBitQ-style) quantizer: rotation, then unit-sphere codes
(PyTorch port of `diskann_tpu/quant/spherical.py`).

Vectors are rotated by a random orthogonal transform, projected to the
unit sphere and quantized at 1-8 bits per dimension; the norm and a code
scale are kept per vector, so a dot reconstructs as ``norm * cscale *
(2/levels * <q, code> - sum(q))``.  Sub-byte codes are stored bit-packed
(`quant/bits.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from diskann_tpu_torch.devices import generator as make_generator
from diskann_tpu_torch.quant.bits import dot_packed, pack_bits, unpack_bits
from diskann_tpu_torch.quant.transforms import train_randomized_hadamard


class SphericalCodes(NamedTuple):
    codes: torch.Tensor   # [N, d] uint8
    norms: torch.Tensor   # [N] f32 vector norms (after the rotation)
    cscale: torch.Tensor  # [N] f32 per-vector code scale (max |u_i|)


class SphericalPackedCodes(NamedTuple):
    """Bit-packed storage: 1/2/4-bit codes at their true footprint."""

    words: torch.Tensor   # [N, W] int32 (the reference's uint32 bits)
    norms: torch.Tensor   # [N] f32
    cscale: torch.Tensor  # [N] f32
    dim: int
    n_bits: int


class SphericalQuantizer(NamedTuple):
    rotation: torch.Tensor  # [d, d] orthogonal (or [d, d_pad] Hadamard rows)
    n_bits: int = 8

    @property
    def levels(self) -> int:
        return (1 << int(self.n_bits)) - 1

    def encode(self, data: torch.Tensor) -> SphericalCodes:
        y = data.float() @ self.rotation
        norms = (y * y).sum(-1).clamp_min(1e-30).sqrt()
        u = y / norms[:, None]
        cscale = u.abs().amax(1).clamp_min(1e-12)
        t = (u / cscale[:, None] + 1.0) * 0.5 * self.levels
        codes = torch.round(t).clamp(0, self.levels).to(torch.uint8)
        return SphericalCodes(codes=codes, norms=norms, cscale=cscale)

    def decode(self, sc: SphericalCodes) -> torch.Tensor:
        u = (sc.codes.float() / self.levels * 2.0 - 1.0) * sc.cscale[:, None]
        return (u * sc.norms[:, None]) @ self.rotation.T

    def rotate_query(self, q: torch.Tensor) -> torch.Tensor:
        return q.float() @ self.rotation

    def pack(self, sc: SphericalCodes) -> SphericalPackedCodes:
        return SphericalPackedCodes(
            words=pack_bits(sc.codes, int(self.n_bits)), norms=sc.norms,
            cscale=sc.cscale, dim=int(sc.codes.shape[-1]), n_bits=int(self.n_bits),
        )

    def unpack(self, pc: SphericalPackedCodes) -> SphericalCodes:
        codes = unpack_bits(pc.words, pc.n_bits, pc.dim).to(torch.uint8)
        return SphericalCodes(codes=codes, norms=pc.norms, cscale=pc.cscale)

    def adc_l2(self, q: torch.Tensor, pc: SphericalPackedCodes) -> torch.Tensor:
        """Asymmetric squared L2 against packed codes: [B, d] x [N, W] ->
        [B, N], from one raw-int dot plus per-row constants
        (||y_hat||^2 ~= norm^2: the codes lie near the unit sphere)."""
        qr = self.rotate_query(q)
        raw = dot_packed(qr, pc.words, pc.n_bits, pc.dim)
        qsum = qr.sum(1, keepdim=True)
        dot_qy = (pc.norms * pc.cscale)[None, :] * ((2.0 / self.levels) * raw - qsum)
        qsq = (qr * qr).sum(1, keepdim=True)
        return qsq + (pc.norms ** 2)[None, :] - 2.0 * dot_qy


def train_spherical(dim: int, n_bits: int = 8, rotation: str = "qr", *,
                    seed: int = 0, generator: torch.Generator | None = None,
                    device=None) -> SphericalQuantizer:
    """A random distance-preserving rotation from ``generator`` (or a new
    one seeded with ``seed`` on ``device``).

    rotation="qr": a dense orthogonal matrix, the QR factor of a gaussian
    one with its column signs fixed; "hadamard": the randomized padded
    double Hadamard (`quant/transforms.py`) as a [dim, dim_pad] matrix,
    whose codes then have dim_pad dimensions."""
    gen = make_generator(seed, generator, device)
    if rotation == "hadamard":
        t = train_randomized_hadamard(dim, generator=gen)
        return SphericalQuantizer(rotation=t.as_matrix(), n_bits=n_bits)
    if rotation != "qr":
        raise ValueError(f"unknown rotation {rotation!r}")
    g = torch.randn((dim, dim), generator=gen, device=gen.device)
    q, r = torch.linalg.qr(g)
    return SphericalQuantizer(rotation=q * torch.sign(torch.diagonal(r))[None, :],
                              n_bits=n_bits)
