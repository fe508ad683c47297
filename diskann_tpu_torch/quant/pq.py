"""Product quantization: codebook training, encoding and decoding (PyTorch
port of `diskann_tpu/quant/pq.py`).

Training runs k-means in every chunk (sub-space) at once; encoding is a
per-chunk distance argmin.  The ADC scan over the codes lives in
`graph/scorers.pq_scorer`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from diskann_tpu_torch.devices import generator as make_generator
from diskann_tpu_torch.quant.kmeans import _lloyd, _pp_init

# bound on the float32 [chunks, rows, centres] blocks of training and
# encoding (1 GiB)
_BLOCK = 1 << 28


class PQ(NamedTuple):
    """Trained product quantizer.  pivots: [m, k, ds] float32."""

    pivots: torch.Tensor
    dim: int          # original dimensionality (before chunk padding)

    @property
    def n_chunks(self) -> int:
        return self.pivots.shape[0]

    @property
    def n_centers(self) -> int:
        return self.pivots.shape[1]

    @property
    def chunk_dim(self) -> int:
        return self.pivots.shape[2]

    def encode(self, data, *, batch: int = 1 << 16) -> torch.Tensor:
        """[N, dim] -> [N, m] uint8 codes (nearest pivot per chunk), on
        the pivots' device."""
        data = torch.as_tensor(data, dtype=torch.float32, device=self.pivots.device)
        m, k, _ = self.pivots.shape
        batch = max(1, min(batch, _BLOCK // (m * k)))
        out = torch.empty((data.shape[0], m), dtype=torch.uint8, device=data.device)
        for off in range(0, data.shape[0], batch):
            out[off:off + batch] = _encode_batch(self.pivots, data[off:off + batch])
        return out

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """Reconstruct [N, dim] from codes."""
        m, _, ds = self.pivots.shape
        c = codes.long()
        rec = self.pivots[torch.arange(m, device=c.device)[None, :], c]  # [N, m, ds]
        return rec.reshape(c.shape[0], m * ds)[:, : self.dim]


def _pad_to_chunks(data: torch.Tensor, m: int, ds: int) -> torch.Tensor:
    n, d = data.shape
    return torch.nn.functional.pad(data, (0, m * ds - d)).reshape(n, m, ds)


def _encode_batch(pivots: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    m, k, ds = pivots.shape
    x = _pad_to_chunks(data.float(), m, ds).transpose(0, 1)      # [m, N, ds]
    xsq = (x * x).sum(-1)
    psq = (pivots * pivots).sum(-1)
    d = (xsq[:, :, None] + psq[:, None, :]
         - 2.0 * (x @ pivots.transpose(1, 2))).clamp_min(0.0)   # [m, N, k]
    return d.argmin(-1).T.to(torch.uint8)


def train_pq(data, n_chunks: int = 8, n_centers: int = 256, *, iters: int = 12,
             max_train_points: int = 1 << 16, seed: int = 0,
             generator: torch.Generator | None = None) -> PQ:
    """Train PQ codebooks: k-means++ and Lloyd in every chunk, the chunks
    in groups whose [chunks, rows, centres] distance block stays under
    1 GiB, on the data's device.  The subsample and the seeds come from
    ``generator`` (or a new one seeded with ``seed``)."""
    data = torch.as_tensor(data, dtype=torch.float32)
    gen = make_generator(seed, generator, data.device)
    n, d = data.shape
    if n > max_train_points:
        sel = torch.randperm(n, generator=gen, device=gen.device)[:max_train_points]
        data = data[sel.to(data.device)]
        n = max_train_points
    ds = -(-d // n_chunks)
    x = _pad_to_chunks(data, n_chunks, ds).transpose(0, 1).contiguous()  # [m, N, ds]
    group = max(1, _BLOCK // (n * n_centers))
    pivots = torch.cat([
        _lloyd(xg, _pp_init(xg, n_centers, gen), iters)[0]
        for xg in x.split(group)
    ])
    return PQ(pivots=pivots, dim=d)
