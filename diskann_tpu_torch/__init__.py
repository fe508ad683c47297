"""diskann_tpu_torch — the PyTorch/CUDA port of diskann_tpu.

The same Vamana index, layouts and algorithms as the JAX package, on one
torch device.  Plain tensor code is PyTorch; the two kernels the JAX
package wrote in Pallas for the TPU are hand-written CUDA for Hopper
(`ops/kernels/csrc/`), built with nvcc at first use.  Modules sit at the
same paths as their JAX counterparts.

    bench/      synthetic clustered data, recall, the streaming runbook
    graph/      Vamana: full and packed build, search (full, packed and
                quantized), prune, packed layout, in-place delete and
                consolidation, range / paged / diverse search
    quant/      PQ, scalar, MinMax, spherical and binary quantizers,
                k-means, packed bit codes, Hadamard transforms
    flat/       brute-force index (the groundtruth) and the bf16 shortlist
                scan of search(mode="auto")
    ops/        distances, top-k, multi-vector scores, the CUDA kernels and
                their plain versions
    service.py  VectorSet / VectorService: named sets, VADD / VSIM semantics
    server.py   the RESP2 server and client (python -m diskann_tpu_torch.server)
    tools/      data tools (python -m diskann_tpu_torch.tools)
    trace.py    spans and the sync counter; testing.py: the fault-injecting scorer
    convert.py  carry an index across (from JAX, or between devices)
    devices.py  the default device (the CUDA card)

Entry points put their tensors on the CUDA card unless given another
device; on a host without a card they raise, so CPU use says
``device="cpu"``.
"""

from diskann_tpu_torch.flat.index import FlatIndex
from diskann_tpu_torch.graph.config import GraphConfig
from diskann_tpu_torch.graph.index import GraphIndex
from diskann_tpu_torch.ops.distance import Metric

__all__ = ["Metric", "GraphConfig", "GraphIndex", "FlatIndex"]
