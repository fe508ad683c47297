"""Label filtering (PyTorch port of `diskann_tpu/filters/`).

Labels live in a dense per-point bitset on the index's device; a query
predicate is a small AST that compiles to gathers, bit tests and boolean
ops over whole candidate batches; the search side is the inline
beta-filter walk, the multihop walk and the exact posting-list scan of
`GraphIndex.search_filtered`."""

from diskann_tpu_torch.filters.labels import LabelSet
from diskann_tpu_torch.filters.predicate import And, Label, Not, Or, parse_predicate
from diskann_tpu_torch.filters.compile import compile_accept

__all__ = [
    "LabelSet",
    "And",
    "Or",
    "Not",
    "Label",
    "parse_predicate",
    "compile_accept",
]
