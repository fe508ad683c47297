"""The system under test, built and served as a configuration file says,
behind the four calls the traffic makes (``search``, ``insert``,
``delete``, ``close``):

- `Port`: one `diskann_tpu_torch.GraphIndex` on one card;
- `Sharded`, for a configuration with a ``shards`` block: a
  `ShardedGraphIndex` on a `Mesh` of one worker process a card (on the
  CPU, one worker process a shard);
- `Filtered`, for a configuration with a ``labels`` block: `Port`'s index
  with the rows' tags attached, every search step one label-filtered
  search with a predicate a query.

`make` picks one.  This is the only module of the benchmark that imports
the port.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def make(cfg: dict, base: torch.Tensor, labels=None):
    """The system ``cfg`` describes, built over ``base`` (and, for a
    filtered configuration, the base rows' tags ``labels``, CSR)."""
    if "shards" in cfg:
        return Sharded(cfg, base)
    return Filtered(cfg, base, labels) if "labels" in cfg else Port(cfg, base)


class Port:
    """``GraphIndex.build`` over ``base`` (then ``attach_packed`` where the
    configuration re-attaches), searched, inserted into and deleted from
    through the index's public entries."""

    def __init__(self, cfg: dict, base: torch.Tensor):
        from diskann_tpu_torch import GraphConfig, GraphIndex

        if cfg["data"]["metric"] != "l2":
            raise ValueError("the benchmark's reference computes squared L2 only")
        b, s = cfg["build"], cfg["serve"]
        self.index = GraphIndex.build(
            base, GraphConfig(**b["graph"]), insert_batch_size=b["insert_batch_size"],
            search_batch_size=s["search_batch_size"], build_mode=b["build_mode"],
            packed_dp=b["packed_dp"], capacity=b["capacity"],
            build_backedge_src_cap=b["build_backedge_src_cap"])
        if s["attach_packed_dp"]:
            self.index.attach_packed(dp=s["attach_packed_dp"])
        self.index.router_compute = s["router_compute"]
        self.k = cfg["k"]
        self.search_kw = s.get("search")
        self.delete_kw = cfg.get("delete") or {}

    def search(self, queries: np.ndarray):
        """(distances [B, k], slot ids [B, k], hops [B])."""
        d, i, stats = self.index.search(queries, self.k, **self.search_kw)
        return d, i, stats.hops

    def insert(self, vectors: torch.Tensor) -> np.ndarray:
        return np.asarray(self.index.insert(vectors), np.int64)

    def delete(self, slots: np.ndarray) -> None:
        self.index.delete(slots, **self.delete_kw)

    def close(self) -> None:
        self.index = None


class Filtered(Port):
    """`Port`'s index, built as `Port` builds it, with the base rows' tags
    attached (``attach_labels``, tag ``i`` named ``str(i)``), searched
    through ``search_filtered`` with the configuration's
    ``serve.filtered`` and each query's own predicate (one tag, or two
    ANDed: ``"3 & 17"``).

    A port that sets ``diskann_tpu_torch.filters.PER_QUERY_PREDICATES``
    takes the tags as CSR (``attach_labels((indptr, tags))``, two integer
    arrays) and a search step's B predicates in one call
    (``search_filtered(queries, [B predicates], k, ...)``).  Without it,
    the tags go in as lists of names, and a step is one call per distinct
    predicate among its queries, the answers put back in query order.

    Inserted rows would come without tags: a filtered system takes no
    inserts."""

    def __init__(self, cfg: dict, base: torch.Tensor, labels):
        from diskann_tpu_torch import filters

        super().__init__(cfg, base)
        self.filtered_kw = cfg["serve"]["filtered"]
        self.per_query = bool(getattr(filters, "PER_QUERY_PREDICATES", False))
        indptr, tags = (t.cpu().numpy() for t in labels)
        if self.per_query:
            self.index.attach_labels((indptr, tags))
        else:
            names = np.array([str(t) for t in range(cfg["labels"]["vocab"])], dtype=object)
            flat = names[tags].tolist()
            self.index.attach_labels([flat[a:b] for a, b in
                                      zip(indptr[:-1].tolist(), indptr[1:].tolist())])

    def search(self, queries: np.ndarray, preds: np.ndarray):
        """(distances [B, k], slot ids [B, k], hops [B]) of ``queries`` [B, d]
        under ``preds`` [B, 2] (tag ids; a second -1: one tag)."""
        names = [str(a) if b < 0 else f"{a} & {b}" for a, b in preds.tolist()]
        if self.per_query:
            d, i, stats = self.index.search_filtered(queries, names, self.k,
                                                     **self.filtered_kw)
            return d, i, stats.hops
        key = preds[:, 0].astype(np.int64) * (1 << 32) + preds[:, 1] + 1
        _, first, inv = np.unique(key, return_index=True, return_inverse=True)
        order = np.argsort(inv.reshape(-1), kind="stable")
        ends = np.cumsum(np.bincount(inv.reshape(-1)))
        out = None
        for g, (at, end) in enumerate(zip(np.concatenate([[0], ends[:-1]]), ends)):
            sel = order[at:end]
            d, i, stats = self.index.search_filtered(queries[sel], names[first[g]], self.k,
                                                     **self.filtered_kw)
            if out is None:
                out = (np.empty((len(names), self.k), d.dtype),
                       np.empty((len(names), self.k), i.dtype),
                       np.empty(len(names), stats.hops.dtype))
            out[0][sel], out[1][sel], out[2][sel] = d, i, stats.hops
        return out

    def insert(self, vectors: torch.Tensor) -> np.ndarray:
        raise NotImplementedError("a filtered system takes no inserts: the rows would "
                                  "come without tags")


class Sharded:
    """A `ShardedGraphIndex` over ``base``, built as `chip_smoke.py`'s
    ``[sharded6m]`` builds it: ``kmeans_partition`` of the base on its
    device, each row in its ``overlap`` nearest shards; shard ``s`` in mesh
    worker ``s`` (on card ``s``), with room for the largest shard's rows
    rounded up to ``build.cap_round``; the base inserted in order in calls
    of ``build.insert_call_rows``, so external id equals row; then
    ``attach_packed``.  Later inserts go to their ``overlap`` nearest
    k-means centres, and get the next external ids, which are again their
    rows in the stream.

    The host's cores are split evenly over the caller and the ``count``
    workers: the caller's torch thread count, which each worker takes
    when the mesh starts, is set to ``cores // (count + 1)`` until
    `close`, so that the processes do not each spin every core.

    ``HOST_SPANS`` names the port's functions that the run times on the
    host clock around every call (`annbench.tracing.HostSpans`)."""

    HOST_SPANS = (("diskann_tpu_torch.parallel.mesh", "MeshShards.walk", "mesh.walk"),
                  ("diskann_tpu_torch.parallel.sharded", "ShardedGraphIndex._merged",
                   "sharded.merged"))

    def __init__(self, cfg: dict, base: torch.Tensor):
        from diskann_tpu_torch import GraphConfig
        from diskann_tpu_torch.parallel import Mesh, ShardedGraphIndex, kmeans_partition

        if cfg["data"]["metric"] != "l2":
            raise ValueError("the benchmark's reference computes squared L2 only")
        sh, b, s = cfg["shards"], cfg["build"], cfg["serve"]
        if sh["partition"] != "kmeans" or sh["shards_per_card"] != 1:
            raise ValueError(f"unsupported shards block {sh}")
        count, self.overlap = int(sh["count"]), int(sh["overlap"])
        dev = base.device
        centres, assign = kmeans_partition(base, count, overlap=self.overlap)
        self.centres = torch.as_tensor(centres, device=dev)
        self.rows_per_shard = np.bincount(assign.ravel(), minlength=count).tolist()
        step, rnd = int(b["insert_call_rows"]), int(b["cap_round"])
        cap = -(-max(self.rows_per_shard) // rnd) * rnd
        cards = ([torch.device("cuda", c) for c in range(count)] if dev.type == "cuda"
                 else [dev] * count)
        self.threads_was = torch.get_num_threads()
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // (count + 1)))
        self.mesh = Mesh(cards)
        self.index = ShardedGraphIndex(self.mesh, base.shape[1], GraphConfig(**b["graph"]),
                                       cap_per_shard=cap)
        x = base.cpu().numpy()
        for off in range(0, x.shape[0], step):
            self.index.insert(x[off:off + step], assign[off:off + step], on_overflow="error")
        self.index.attach_packed(dp=s["attach_packed_dp"])
        self.k = cfg["k"]
        self.search_kw = s["search"]

    def search(self, queries: np.ndarray):
        """(distances [B, k], external ids [B, k], None: a sharded search
        counts comparisons, not hops)."""
        d, i, _ = self.index.search(queries, self.k, **self.search_kw)
        return d, i, None

    def insert(self, vectors: torch.Tensor) -> np.ndarray:
        v = vectors.to(self.centres.device).float()
        d = (v * v).sum(1, keepdim=True) - 2.0 * v @ self.centres.T \
            + (self.centres * self.centres).sum(1)
        assign = torch.argsort(d, dim=1, stable=True)[:, :self.overlap]
        return np.asarray(self.index.insert(v.cpu().numpy(), assign.cpu().numpy()), np.int64)

    def delete(self, ext_ids: np.ndarray) -> None:
        self.index.delete(ext_ids)

    def on_cards(self, fn, *args) -> dict:
        """``fn(*args)`` in every mesh worker (a function importable by name
        there): {"<device type>:<worker>": result}, worker ``w`` on card
        ``w``."""
        return {f"{d.type}:{w}": r
                for w, (d, r) in enumerate(zip(self.mesh.devices, self.mesh.run(fn, *args)))}

    def close(self) -> None:
        """Drop the index, end the mesh's workers, waiting for each, and give
        the caller its thread count back."""
        self.index = None
        if self.mesh is not None:
            self.mesh._finalizer()
            self.mesh = None
            torch.set_num_threads(self.threads_was)
