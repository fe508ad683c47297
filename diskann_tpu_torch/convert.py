"""Carry an index across from the JAX package: numpy arrays in, a port
`GraphIndex` on a chosen device out.

The layouts are the same in both packages (int32 ids with -1 padding, the
``[(cap+1)*nwr, 128]`` int32 fat-row table with its dump row, float32
vectors), so the arrays are copied as they are.  Pulling the arrays out of
a JAX index is the caller's business: this package never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from diskann_tpu_torch.devices import default_device
from diskann_tpu_torch.filters.labels import LabelSet
from diskann_tpu_torch.graph.config import GraphConfig
from diskann_tpu_torch.graph.index import GraphIndex
from diskann_tpu_torch.graph.packed import PackedState, n_wrows
from diskann_tpu_torch.graph.state import GraphArrays
from diskann_tpu_torch.ops.distance import Metric

_GRAPH_DTYPES = {
    "vectors": torch.float32,
    "sq_norms": torch.float32,
    "adjacency": torch.int32,
    "degrees": torch.int32,
    "valid": torch.bool,
    "vec_sum": torch.float32,
}
_PACKED_DTYPES = {
    "proj": torch.float32,
    "pscale": torch.float32,
    "pbias2": torch.float32,
    "self_codes": torch.int8,
    "self_aux": torch.float32,
    "rows": torch.int32,
}


def graph_index_from_arrays(
    *,
    config: dict,
    graph: dict,
    packed: dict | None,
    n: int,
    n_deleted: int = 0,
    free_slots=(),
    labels: dict | None = None,
    device=None,
    **index_kwargs,
) -> GraphIndex:
    """Build a port `GraphIndex` from the reference index's arrays.

    config: the `GraphConfig` fields (``metric`` as a `Metric` or its
    value); graph: the `GraphArrays` fields as numpy arrays; packed: the
    `PackedState` fields as numpy arrays plus ``r_pack``, or None;
    n, n_deleted: the index's counters; free_slots: its freelist, in
    order (the last entry is reused first); labels: ``{"vocab": dict, "bits":
    [cap, n_words] uint32 array}`` of the reference's `LabelSet`, or None
    (the words are carried as int32 with the same bits).  index_kwargs go
    to `GraphIndex` (batch sizes, backedge cap).  The index goes on
    ``device``, by default the CUDA card."""
    device = default_device(device)
    cfg = dict(config)
    cfg["metric"] = Metric(cfg["metric"])
    cfg = GraphConfig(**cfg)

    def put(arrays, dtypes):
        # copies: the index updates its tensors in place
        return {k: torch.as_tensor(np.array(arrays[k]), device=device).to(dt)
                for k, dt in dtypes.items()}

    g = GraphArrays(**put(graph, _GRAPH_DTYPES))
    cap, r_slack = g.adjacency.shape
    if r_slack != cfg.max_degree_with_slack:
        raise ValueError(
            f"adjacency width {r_slack} != max_degree_with_slack "
            f"{cfg.max_degree_with_slack} of the config"
        )
    idx = GraphIndex(g.dim, cfg, capacity=1, device=device, **index_kwargs)
    idx.state = g
    if packed is not None:
        p = PackedState(**put(packed, _PACKED_DTYPES), r_pack=int(packed["r_pack"]))
        want = ((cap + 1) * n_wrows(p.r_pack, p.dp), 128)
        if tuple(p.rows.shape) != want or p.self_codes.shape[0] != cap:
            raise ValueError(
                f"packed table {tuple(p.rows.shape)} does not match capacity "
                f"{cap} (want rows {want})"
            )
        idx.packed = p
    if labels is not None:
        bits = np.ascontiguousarray(labels["bits"], np.uint32)
        if bits.ndim != 2 or bits.shape[0] != cap:
            raise ValueError(f"label bits {bits.shape} do not match capacity {cap}")
        ls = LabelSet(cap, labels["vocab"], bits.shape[1], device=device)
        ls.bits = torch.from_numpy(bits.view(np.int32).copy()).to(device)
        idx.labels = ls
    idx.n = int(n)
    idx.n_deleted = int(n_deleted)
    idx.free_slots = [int(i) for i in free_slots]
    return idx
