"""Memory tiering (PyTorch port of `diskann_tpu/tiered/`): quantized codes
and the graph on the card, full vectors in host RAM.

The reference keeps PQ codes in RAM for traversal and reads full-precision
sectors from NVMe for the rerank; here the hierarchy is card memory over
host RAM: the walk runs on the card over compact codes, and each query
batch's candidate rows are gathered on the host (the native mmap reader,
`diskann_tpu_torch.native`) and uploaded for an exact rerank.
`build_merged` builds such an index shard by shard when the build itself
does not fit the card."""

from diskann_tpu_torch.tiered.index import HostVectorStore, TieredIndex
from diskann_tpu_torch.tiered.merged_build import build_merged
from diskann_tpu_torch.tiered.stores import SqliteVectorStore

__all__ = ["TieredIndex", "HostVectorStore", "SqliteVectorStore", "build_merged"]
