"""FlatIndex: exact brute-force top-k scan (PyTorch port of
`diskann_tpu/flat/index.py`, float32 scan only).

The scan is one (queries x database-chunk) float32 distance product per
chunk, an exact per-chunk top-k, and a stable merge into the running best
list.  It is the groundtruth for every recall figure of the port."""

from __future__ import annotations

import torch

from diskann_tpu_torch.devices import default_device
from diskann_tpu_torch.ops.distance import Metric, distance_to_set, squared_norms
from diskann_tpu_torch.ops.topk import merge_sorted


class FlatIndex:
    """Exact top-k index over a database held on one device."""

    def __init__(self, vectors, metric: Metric = Metric.L2, *, device=None):
        """vectors: [n, d] numpy array or tensor.  The scan runs on
        ``device``; by default on a tensor's own device, and for a numpy
        array on the CUDA card (`devices.default_device`)."""
        if device is not None or not isinstance(vectors, torch.Tensor):
            device = default_device(device)
        vectors = torch.as_tensor(vectors, dtype=torch.float32, device=device)
        self.n, self.dim = vectors.shape
        self.metric = metric
        self.vectors = vectors
        if metric.needs_norms:
            self.sq_norms = squared_norms(vectors)
        else:
            self.sq_norms = torch.zeros(self.n, device=vectors.device)

    def search(self, queries, k: int):
        """Exact k-NN. queries: [B, d]. Returns (dists [B,k], ids [B,k])
        as numpy arrays."""
        q = torch.as_tensor(queries, dtype=torch.float32,
                            device=self.vectors.device)
        # L1 has no product form: its [B, chunk, d] difference block bounds
        # the chunk
        chunk = min(2048 if self.metric == Metric.L1 else 1 << 14, self.n)
        b = q.shape[0]
        q_sq = squared_norms(q) if self.metric.needs_norms else None
        best_d = torch.full((b, k), float("inf"), device=q.device)
        best_i = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
        for start in range(0, self.n, chunk):
            v = self.vectors[start:start + chunk]
            d = distance_to_set(q, v, self.metric,
                                x_sq_norms=self.sq_norms[start:start + chunk],
                                q_sq_norms=q_sq)
            kk = min(k, v.shape[0])
            nd, nidx = torch.topk(d, kk, dim=1, largest=False, sorted=True)
            best_d, best_i = merge_sorted(
                best_d, best_i, nd, (nidx + start).to(torch.int32), k
            )
        return best_d.cpu().numpy(), best_i.cpu().numpy()
