"""The quantization stack (PyTorch port of `diskann_tpu/quant/`).

- kmeans: k-means++ and Lloyd's iterations
- pq: product quantizer (training, encode, decode)
- scalar: per-dimension int8 quantizer with sigma clipping
- minmax: per-vector training-free quantizer
- spherical: rotated unit-sphere codes, bit-packed below 8 bits
- binary: sign bits and Hamming distance
- bits: 1/2/4/8-bit packed words and the distances over them
- transforms: fast Walsh-Hadamard and its randomized form

Every random draw (k-means++ seeding, the PQ subsample, the rotations)
takes a ``torch.Generator`` or a ``seed``.
"""

from diskann_tpu_torch.quant.binary import BinaryQuantizer
from diskann_tpu_torch.quant.bits import (
    dot_packed, hamming_packed, pack_bits, unpack_bits,
)
from diskann_tpu_torch.quant.kmeans import kmeans, kmeans_pp_init, lloyd
from diskann_tpu_torch.quant.minmax import MinMaxQuantizer
from diskann_tpu_torch.quant.pq import PQ, train_pq
from diskann_tpu_torch.quant.scalar import ScalarQuantizer, train_scalar
from diskann_tpu_torch.quant.spherical import SphericalQuantizer, train_spherical

__all__ = [
    "dot_packed",
    "hamming_packed",
    "pack_bits",
    "unpack_bits",
    "kmeans",
    "kmeans_pp_init",
    "lloyd",
    "PQ",
    "train_pq",
    "ScalarQuantizer",
    "train_scalar",
    "MinMaxQuantizer",
    "SphericalQuantizer",
    "train_spherical",
    "BinaryQuantizer",
]
