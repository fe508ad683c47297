"""Seeded clustered vectors, made on the device.

The distribution of `make_clustered` (the port's and the JAX package's
synthetic stand-in for SIFT): ``n_clusters`` centres drawn from N(0, 1) in
``dim`` dimensions, each point a centre chosen uniformly plus
N(0, sigma^2) noise, queries from the same mixture.  This copy draws with a
`torch.Generator` on the device, in a few large calls, so the arrays differ
from the numpy original's for the same seed; the distribution is the same.

With ``grid: "uint8"`` every row and query is mapped to ``32 x + 128``
and rounded to an integer in [0, 255] (8 standard deviations of the centres
over the 256 levels), still stored as float32: a source's uint8 vectors,
standing in.

Rows are numbered globally and cut into slices of ``slice_rows``: slice
``j`` depends only on the seed and ``j``, so a stream can draw as many
slices as the program gets through and any party can draw slice ``j`` again.

`Tagged` gives the rows a bag of tags each and the query pool one predicate
each (a configuration's ``labels`` and ``predicates`` blocks), the same way:
slice ``j``'s tags depend only on the seed and ``j``.
"""

from __future__ import annotations

import torch

_GOLDEN = 0x9E3779B97F4A7C15
_MIX = 0xBF58476D1CE4E5B9
# stream ids: the centres, the query pool, then one per slice of rows; the
# tags' streams are negative: the clusters' tag lists, the predicates, then
# one per slice of rows, downwards
CENTRES = 0
QUERIES = 1
_SLICE0 = 2
_TAG_LISTS = -2
_PREDICATES = -3
_TAGS0 = -4


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
        self.grid = data.get("grid")
        if self.grid not in (None, "uint8"):
            raise ValueError(f"unknown grid {self.grid!r}")
        self.device = torch.device(device)
        self.centres = torch.randn((int(data["clusters"]), self.dim),
                                   generator=generator(seed, CENTRES, device),
                                   device=self.device)

    def _assign(self, g: torch.Generator, n: int) -> torch.Tensor:
        return torch.randint(0, self.centres.shape[0], (n,), generator=g,
                             device=self.device)

    def _draw(self, stream: int, n: int) -> torch.Tensor:
        g = generator(self.seed, stream, self.device)
        a = self._assign(g, n)
        noise = torch.randn((n, self.dim), generator=g, device=self.device)
        x = self.centres[a] + self.sigma * noise
        if self.grid == "uint8":
            x = torch.round(x * 32.0 + 128.0).clamp_(0.0, 255.0)
        return x

    def clusters(self, lo: int, hi: int) -> torch.Tensor:
        """The centre each of rows [lo, hi) was drawn around, int64 [hi - lo]."""
        s = self.slice_rows
        parts = [self._assign(generator(self.seed, _SLICE0 + j, self.device), s)
                 [max(lo - j * s, 0):min(hi - j * s, s)] for j in range(lo // s, -(-hi // s))]
        return torch.cat(parts) if parts else torch.empty(0, dtype=torch.int64,
                                                          device=self.device)

    def query_clusters(self, n: int) -> torch.Tensor:
        """The centre each query of the pool was drawn around, int64 [n]."""
        return self._assign(generator(self.seed, QUERIES, self.device), n)

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


class Tagged:
    """The tags of the rows of ``data`` and the predicates of its query pool,
    as a configuration's ``labels`` and ``predicates`` blocks say.

    A row carries ``1 + Poisson(per_row.mean - 1)`` tags (at most
    ``per_row.max``, repeats dropped) out of ``vocab``: each one, with
    probability ``cluster_share``, one of the ``cluster_tags`` tags of its
    cluster's list, else a tag drawn by global popularity (Zipf with
    exponent ``zipf_s`` over the tag ids, tag 0 the most popular); each
    cluster's list is drawn by the same popularity.  Content tags follow
    content, the rest do not.  Tags come as CSR: ``indptr`` int64 [rows + 1],
    tag ids int32 (ascending within a row).  Tag ``i`` is named ``str(i)``.

    A predicate is one tag, or with probability ``and2_share`` two distinct
    tags ANDed: int32 [2], the second -1 for one tag.  With probability
    ``correlated_share`` its tags are tags of a seeded base row of the
    query's own cluster, else each is the tag of a seeded (row, tag) entry
    of the whole base, which draws it by its popularity there.  Every tag a
    predicate names is carried by some base row; a predicate may match
    fewer than k rows, or none."""

    def __init__(self, seed: int, cfg: dict, data: Clustered):
        lab, pred = cfg["labels"], cfg["predicates"]
        self.seed = int(seed)
        self.data = data
        self.vocab = int(lab["vocab"])
        self.mean = float(lab["per_row"]["mean"])
        self.max = int(lab["per_row"]["max"])
        if not 1.0 <= self.mean <= self.max:
            raise ValueError(f"per_row {lab['per_row']}: 1 <= mean <= max")
        self.cluster_share = float(lab["cluster_share"])
        self.and2_share = float(pred["and2_share"])
        self.correlated_share = float(pred["correlated_share"])
        dev = data.device
        w = torch.arange(1, self.vocab + 1, dtype=torch.float64, device=dev) ** -float(
            lab["zipf_s"])
        self.cdf = torch.cumsum(w, 0) / w.sum()
        clusters = data.centres.shape[0]
        self.lists = self._zipf(generator(seed, _TAG_LISTS, dev),
                                (clusters, int(lab["cluster_tags"])))

    def _zipf(self, g: torch.Generator, shape) -> torch.Tensor:
        u = torch.rand(shape, dtype=torch.float64, generator=g, device=self.data.device)
        return torch.searchsorted(self.cdf, u).clamp_(max=self.vocab - 1)

    def _bags(self, g: torch.Generator, clusters: torch.Tensor):
        """One bag of tags for each of ``clusters`` (a row's cluster): CSR."""
        dev, n = self.data.device, clusters.shape[0]
        rates = torch.full((n,), self.mean - 1.0, device=dev)
        count = (1 + torch.poisson(rates, generator=g).long()).clamp_(max=self.max)
        row = torch.repeat_interleave(torch.arange(n, device=dev), count)
        nnz = row.shape[0]
        own = torch.rand(nnz, generator=g, device=dev) < self.cluster_share
        pick = torch.randint(0, self.lists.shape[1], (nnz,), generator=g, device=dev)
        tags = torch.where(own, self.lists[clusters[row], pick], self._zipf(g, (nnz,)))
        key = torch.unique(row * self.vocab + tags)          # sorted: by row, then tag
        indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        indptr[1:] = torch.cumsum(torch.bincount(key // self.vocab, minlength=n), 0)
        return indptr, (key % self.vocab).int()

    def slice(self, j: int):
        """The tags of rows [j * slice_rows, (j + 1) * slice_rows), CSR."""
        s = self.data.slice_rows
        g = generator(self.seed, _TAGS0 - j, self.data.device)
        return self._bags(g, self.data.clusters(j * s, (j + 1) * s))

    def rows(self, lo: int, hi: int):
        """The tags of rows [lo, hi), CSR."""
        s = self.data.slice_rows
        ptrs, tags, base = [torch.zeros(1, dtype=torch.int64, device=self.data.device)], [], 0
        for j in range(lo // s, -(-hi // s)):
            indptr, t = self.slice(j)
            a, b = max(lo - j * s, 0), min(hi - j * s, s)
            ptrs.append(indptr[a + 1:b + 1] - indptr[a] + base)
            tags.append(t[indptr[a]:indptr[b]])
            base += int(indptr[b] - indptr[a])
        return (torch.cat(ptrs),
                torch.cat(tags) if tags else torch.empty(0, dtype=torch.int32,
                                                         device=self.data.device))

    def predicates(self, n: int, base_rows: int) -> torch.Tensor:
        """One predicate for each of the pool's first ``n`` queries, over the
        base rows [0, ``base_rows``): int32 [n, 2]."""
        dev = self.data.device
        indptr, tags = self.rows(0, base_rows)
        clusters = self.data.clusters(0, base_rows)
        qc = self.data.query_clusters(n)
        g = generator(self.seed, _PREDICATES, dev)
        u = torch.rand((n, 5), dtype=torch.float64, generator=g, device=dev)
        # a seeded base row of the query's cluster, where the cluster has one
        order = torch.argsort(clusters, stable=True)
        per = torch.bincount(clusters, minlength=self.data.centres.shape[0])
        start = torch.cumsum(per, 0) - per
        own = (u[:, 0] < self.correlated_share) & (per[qc] > 0)
        row = order[(start[qc] + (u[:, 1] * per[qc]).long()).clamp_(max=base_rows - 1)]
        at, cnt = indptr[row], indptr[row + 1] - indptr[row]
        j1 = (u[:, 2] * cnt).long()
        j2 = (j1 + 1 + (u[:, 3] * (cnt - 1)).long()) % cnt
        c1, c2 = tags[at + j1], torch.where(cnt > 1, tags[at + j2], -1)
        # tags of seeded entries of the whole base: drawn by popularity
        e = torch.randint(0, tags.shape[0], (n, 2), generator=g, device=dev)
        t1 = torch.where(own, c1, tags[e[:, 0]])
        t2 = torch.where(own, c2, tags[e[:, 1]])
        t2 = torch.where((u[:, 4] < self.and2_share) & (t2 != t1), t2, -1)
        return torch.stack([t1, t2], 1).int()
