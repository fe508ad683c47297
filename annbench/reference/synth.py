"""Seeded clustered vectors, made on the device.

The distribution of `make_clustered` (the port's and the JAX package's
synthetic stand-in for SIFT): ``n_clusters`` centres drawn from N(0, 1) in
``dim`` dimensions, each point a centre chosen uniformly plus
N(0, sigma^2) noise, queries from the same mixture.  This copy draws with a
`torch.Generator` on the device, in a few large calls, so the arrays differ
from the numpy original's for the same seed; the distribution is the same.

Rows are numbered globally and cut into slices of ``slice_rows``: slice
``j`` depends only on the seed and ``j``, so a stream can draw as many
slices as the program gets through and any party can draw slice ``j`` again.
"""

from __future__ import annotations

import torch

_GOLDEN = 0x9E3779B97F4A7C15
_MIX = 0xBF58476D1CE4E5B9
# stream ids: the centres, the query pool, then one per slice of rows
CENTRES = 0
QUERIES = 1
_SLICE0 = 2


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for (``seed``, ``stream``); any whole seed,
    however large, is reduced into range."""
    return (int(seed) * _GOLDEN + (int(stream) + 1) * _MIX) % (1 << 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(stream_seed(seed, stream))
    return g


class Clustered:
    """The seeded mixture of one run: ``centres`` on ``device``, and rows,
    slices and queries drawn from it."""

    def __init__(self, seed: int, data: dict, device):
        self.seed = int(seed)
        self.dim = int(data["dim"])
        self.sigma = float(data["sigma"])
        self.slice_rows = int(data["slice_rows"])
        self.device = torch.device(device)
        self.centres = torch.randn((int(data["clusters"]), self.dim),
                                   generator=generator(seed, CENTRES, device),
                                   device=self.device)

    def _draw(self, stream: int, n: int) -> torch.Tensor:
        g = generator(self.seed, stream, self.device)
        a = torch.randint(0, self.centres.shape[0], (n,), generator=g,
                          device=self.device)
        noise = torch.randn((n, self.dim), generator=g, device=self.device)
        return self.centres[a] + self.sigma * noise

    def slice(self, j: int) -> torch.Tensor:
        """Rows [j * slice_rows, (j + 1) * slice_rows), float32 [slice_rows, dim]."""
        return self._draw(_SLICE0 + j, self.slice_rows)

    def rows(self, lo: int, hi: int) -> torch.Tensor:
        """Rows [lo, hi) of the stream, float32 [hi - lo, dim]."""
        s = self.slice_rows
        parts = [self.slice(j)[max(lo - j * s, 0):min(hi - j * s, s)]
                 for j in range(lo // s, -(-hi // s))]
        return torch.cat(parts) if parts else torch.empty((0, self.dim),
                                                          device=self.device)

    def queries(self, n: int) -> torch.Tensor:
        """The query pool, float32 [n, dim]."""
        return self._draw(QUERIES, n)
