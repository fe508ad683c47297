"""Vamana graph: build, search, prune, in-place delete and consolidation,
and the range / paged / diverse search modes (`graph/modes.py`)."""

from diskann_tpu_torch.graph.config import GraphConfig, PruneKind
from diskann_tpu_torch.graph.index import GraphIndex
from diskann_tpu_torch.graph.prune import PruneResult, robust_prune
from diskann_tpu_torch.graph.search import SearchResult, beam_search_scored

__all__ = [
    "GraphConfig",
    "PruneKind",
    "GraphIndex",
    "beam_search_scored",
    "SearchResult",
    "robust_prune",
    "PruneResult",
]
