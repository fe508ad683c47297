"""The system under test: a `diskann_tpu_torch.GraphIndex`, built and served
as a configuration file says, behind the four calls the traffic makes.

This is the only module of the benchmark that imports the port.
"""

from __future__ import annotations

import numpy as np
import torch


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
        self.search_kw = s["search"]
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
