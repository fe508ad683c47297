"""K-means: k-means++ seeding and Lloyd's iterations (PyTorch port of
`diskann_tpu/quant/kmeans.py`).

Each Lloyd iteration is one [N, K] distance product, an argmin and a
scatter-add of the points into their centroids; k-means++ draws K centres
in sequence, each with probability proportional to the squared distance
to the nearest centre so far.  The internal forms take a leading group
axis, so PQ trains all its sub-spaces in one batch as the reference's
vmap does.
"""

from __future__ import annotations

import torch

from diskann_tpu_torch.devices import generator as make_generator


def _pp_init(data: torch.Tensor, k: int, gen: torch.Generator) -> torch.Tensor:
    """k-means++ over each group: data [G, N, d] -> centres [G, k, d]."""
    g, n, d = data.shape
    data = data.float()
    sq = (data * data).sum(-1)                                  # [G, N]
    rows = torch.arange(g, device=data.device)

    def center_dist(c):                                          # c [G, d]
        dots = (data @ c[:, :, None]).squeeze(-1)
        return (sq - 2.0 * dots + (c * c).sum(-1, keepdim=True)).clamp_min(0.0)

    first = torch.randint(0, n, (g,), generator=gen, device=gen.device)
    c = data[rows, first.to(data.device)]
    centers = torch.zeros((g, k, d), device=data.device)
    centers[:, 0] = c
    min_d = center_dist(c)
    for i in range(1, k):
        # probability proportional to max(min_d, 1e-30), as the reference's
        # categorical draw over log(max(min_d, 1e-30))
        w = min_d.clamp_min(1e-30).to(gen.device)
        idx = torch.multinomial(w, 1, generator=gen).squeeze(1).to(data.device)
        c = data[rows, idx]
        centers[:, i] = c
        min_d = torch.minimum(min_d, center_dist(c))
    return centers


def _assign(data: torch.Tensor, sq: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each point (first on ties): [G, N] int64."""
    csq = (cent * cent).sum(-1)
    dist = (sq[:, :, None] + csq[:, None, :]
            - 2.0 * (data @ cent.transpose(1, 2))).clamp_min(0.0)
    return dist.argmin(-1)


def _lloyd(data: torch.Tensor, cent: torch.Tensor, iters: int):
    """Lloyd's iterations per group: data [G, N, d], cent [G, K, d] ->
    (centroids [G, K, d], assignments [G, N] int32).  An empty cluster
    keeps its centroid."""
    data = data.float()
    cent = cent.float()
    g, n, d = data.shape
    k = cent.shape[1]
    sq = (data * data).sum(-1)
    for _ in range(iters):
        assign = _assign(data, sq, cent)
        sums = torch.zeros((g, k, d), device=data.device)
        sums.scatter_add_(1, assign[:, :, None].expand(g, n, d), data)
        counts = torch.zeros((g, k), device=data.device)
        counts.scatter_add_(1, assign, torch.ones_like(sq))
        cent = torch.where(counts[:, :, None] > 0,
                           sums / counts.clamp_min(1)[:, :, None], cent)
    return cent, _assign(data, sq, cent).to(torch.int32)


def kmeans_pp_init(data: torch.Tensor, k: int, *, seed: int = 0,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """k-means++ seeding: [N, d] -> [k, d] centres drawn from the rows of
    data with ``generator`` (or a new one seeded with ``seed``)."""
    gen = make_generator(seed, generator, data.device)
    return _pp_init(data[None], k, gen)[0]


def lloyd(data: torch.Tensor, centroids: torch.Tensor, iters: int = 10):
    """Lloyd's iterations from ``centroids``.  Returns (centroids [K, d],
    assignments [N] int32)."""
    cent, assign = _lloyd(data[None], centroids[None], iters)
    return cent[0], assign[0]


def kmeans(data: torch.Tensor, k: int, *, iters: int = 10,
           max_train_points: int = 1 << 17, seed: int = 0,
           generator: torch.Generator | None = None):
    """Subsample to ``max_train_points``, k-means++, then Lloyd.  Returns
    (centroids, assignments of the training subset)."""
    gen = make_generator(seed, generator, data.device)
    n = data.shape[0]
    if n > max_train_points:
        sel = torch.randperm(n, generator=gen, device=gen.device)[:max_train_points]
        data = data[sel.to(data.device)]
    cent, assign = _lloyd(data[None], _pp_init(data[None], k, gen), iters)
    return cent[0], assign[0]
