"""Device-resident graph index state (PyTorch port of `diskann_tpu/graph/state.py`).

Fixed-capacity dense tensors on one device:

- ``vectors  [cap, d]`` vector data, float32 by default; float16, bfloat16,
  int8 and uint8 are also held, and every distance lifts them to float32,
- ``sq_norms [cap]``    squared norms (L2/cosine matmul form),
- ``adjacency[cap, R_slack] int32`` fixed-degree padded graph, -1 = empty,
- ``degrees  [cap] int32`` live out-degree per node,
- ``valid    [cap] bool`` liveness bitmap,
- ``vec_sum  [d] float32`` running sum of live vectors (medoid upkeep).

Unlike the reference's functional pytree, the tensors are updated in place:
the reference donated these buffers to its jitted updates for the same
reason, to keep one copy of each multi-GB table.  Where the reference
commits a batch by rebinding the pytree it returns, so that a batch that
raises commits nothing, the port writes through a `RowJournal` that keeps
what each write overwrote and puts it back when the batch fails.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from diskann_tpu_torch.ops.distance import squared_norms

# the vector dtypes the reference stores, by the name its records use
VECTOR_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
}


def dtype_name(dtype: torch.dtype) -> str:
    """The name a record gives ``dtype`` (numpy's, as the reference writes)."""
    return str(dtype).removeprefix("torch.")


def vector_dtype(dtype) -> torch.dtype:
    """A torch dtype, a numpy dtype or a name (``"bfloat16"``, ...) as one
    of the torch dtypes in `VECTOR_DTYPES`."""
    if isinstance(dtype, torch.dtype):
        name = dtype_name(dtype)
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in VECTOR_DTYPES:
        raise ValueError(f"vector dtype {dtype!r}: one of {sorted(VECTOR_DTYPES)}")
    return VECTOR_DTYPES[name]


def to_stored(vecs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``vecs`` cast to the stored ``dtype`` as the reference casts: an
    integer dtype saturates at its range (a torch cast would wrap around),
    then rounds toward zero."""
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        vecs = vecs.clamp(info.min, info.max)
    return vecs.to(dtype)


def vectors_to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bfloat16 as its raw uint16 bits, since numpy
    knows that type only through ml_dtypes."""
    if t.dtype == torch.bfloat16:
        return t.cpu().view(torch.int16).numpy().view(np.uint16)
    return t.cpu().numpy()


def vectors_from_host(a, dtype=None) -> torch.Tensor:
    """A CPU tensor of ``dtype`` (default: ``a``'s own) from numpy array
    ``a``.  A bfloat16 array, with ml_dtypes or as its raw uint16 bits
    when ``dtype`` is bfloat16, keeps its bits."""
    a = np.ascontiguousarray(a)
    bf16 = a.dtype.name == "bfloat16" or (
        dtype is not None and vector_dtype(dtype) == torch.bfloat16
        and a.dtype == np.uint16)
    if bf16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    t = torch.from_numpy(a.copy())
    return t if dtype is None else t.to(vector_dtype(dtype))


class GraphArrays(NamedTuple):
    vectors: torch.Tensor    # [cap, d]
    sq_norms: torch.Tensor   # [cap] f32
    adjacency: torch.Tensor  # [cap, R_slack] i32
    degrees: torch.Tensor    # [cap] i32
    valid: torch.Tensor      # [cap] bool
    vec_sum: torch.Tensor    # [d] f32

    @property
    def capacity(self) -> int:
        return self.adjacency.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def max_degree_slack(self) -> int:
        return self.adjacency.shape[1]


def alloc(capacity: int, dim: int, r_slack: int, dtype=torch.float32, *,
          device=None) -> GraphArrays:
    return GraphArrays(
        vectors=torch.zeros((capacity, dim), dtype=vector_dtype(dtype), device=device),
        sq_norms=torch.zeros((capacity,), device=device),
        adjacency=torch.full((capacity, r_slack), -1, dtype=torch.int32,
                             device=device),
        degrees=torch.zeros((capacity,), dtype=torch.int32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        vec_sum=torch.zeros((dim,), device=device),
    )


def grow(state: GraphArrays, new_capacity: int) -> GraphArrays:
    extra = new_capacity - state.capacity
    if extra < 0:
        raise ValueError("graph capacity only grows")
    f = torch.nn.functional.pad
    return GraphArrays(
        vectors=f(state.vectors, (0, 0, 0, extra)),
        sq_norms=f(state.sq_norms, (0, extra)),
        adjacency=f(state.adjacency, (0, 0, 0, extra), value=-1),
        degrees=f(state.degrees, (0, extra)),
        valid=f(state.valid, (0, extra)),
        vec_sum=state.vec_sum,
    )


class RowJournal:
    """The rows an in-place batch overwrites, kept so that a batch that
    fails part-way can be undone bitwise.

    Each writer calls `save` just before it writes, with the rows it is
    about to write; `restore` writes the saved rows back, the latest
    first, so a row saved twice ends as it was before the first write.
    Saves and restores are ordinary ops on the tensors' device and
    stream, queued after every write made so far, so no host copy and no
    wait is involved.  A sticky CUDA error (an illegal address, a
    device-side assert) poisons the context: no restore can run then.
    ``nbytes`` counts the device bytes held (copies and row indices)."""

    def __init__(self):
        self._saved: list = []
        self.nbytes = 0

    def save(self, tensor: torch.Tensor, rows: torch.Tensor | None = None) -> None:
        """Keep ``tensor[rows]`` (``rows``: int64 indices into dim 0,
        repeats allowed; a view of a larger tensor works, the restore
        writes through it), or the whole of a small ``tensor`` when
        ``rows`` is None."""
        copy = tensor.clone() if rows is None else tensor[rows]
        self._saved.append((tensor, rows, copy))
        self.nbytes += copy.numel() * copy.element_size()
        if rows is not None:
            self.nbytes += rows.numel() * rows.element_size()

    def restore(self) -> None:
        """Write every saved row back, the latest save first, and forget
        them."""
        for tensor, rows, copy in reversed(self._saved):
            if rows is None:
                tensor.copy_(copy)
            else:
                tensor.index_copy_(0, rows, copy)
        self._saved.clear()

    def drop(self) -> None:
        """Forget the saved rows: the batch committed."""
        self._saved.clear()


def set_vectors(state: GraphArrays, slot_ids, vecs, row_valid=None,
                journal: RowJournal | None = None) -> GraphArrays:
    """Write a batch of vectors at ``slot_ids`` in place (phase 1 of
    multi_insert).  Rows masked out by ``row_valid`` are not written: the
    reference aims them at index ``cap`` and lets the scatter drop them,
    which a torch scatter would refuse, so they are filtered here.  The
    rows are cast to the stored dtype first; the norms and the running sum
    are taken from the cast values, in float32.  ``journal`` keeps the
    rows and the sum first."""
    vecs = to_stored(vecs, state.vectors.dtype)
    if row_valid is None:
        row_valid = torch.ones(vecs.shape[0], dtype=torch.bool,
                               device=vecs.device)
    vecs = torch.where(row_valid[:, None], vecs, 0)
    keep = row_valid & (slot_ids >= 0) & (slot_ids < state.capacity)
    w = slot_ids[keep].long()
    if journal is not None:
        for t in (state.vectors, state.sq_norms, state.valid):
            journal.save(t, w)
        journal.save(state.vec_sum)
    state.vectors[w] = vecs[keep]
    state.sq_norms[w] = squared_norms(vecs[keep])
    state.valid[w] = True
    state.vec_sum.add_(vecs.float().sum(0))
    return state


def medoid(state: GraphArrays, n: int) -> torch.Tensor:
    """Index of the live vector closest to the running mean, as a 0-d
    int32 tensor."""
    mean = state.vec_sum / max(float(n), 1.0)
    d2 = state.sq_norms - 2.0 * (state.vectors.float() @ mean)
    d2 = torch.where(state.valid, d2, float("inf"))
    return torch.argmin(d2).to(torch.int32)


def start_ids(state: GraphArrays, n: int, strategy: str = "medoid", k: int = 1,
              seed: int = 0) -> torch.Tensor:
    """Entry-point ids for a graph walk, [S] int32 ascending — the start
    point strategy family:

    - "medoid": the live vector closest to the running mean;
    - "first_vector": the first live id;
    - "random_samples": ``k`` random live ids;
    - "latin_hypercube": the live ids cut into ``k`` strata, one random id
      from each;
    - "random_vectors": ``k`` random Gaussian vectors, each mapped to its
      nearest live node.

    The random strategies draw from ``np.random.default_rng(seed)`` over
    the live ids among the first ``n`` slots, as the reference does."""
    if strategy == "medoid":
        return medoid(state, n)[None]
    dev = state.adjacency.device
    valid = state.valid[:n].cpu().numpy()
    live = np.nonzero(valid)[0]
    if len(live) == 0:
        return torch.full((max(k, 1),), -1, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(seed)
    if strategy == "first_vector":
        sel = live[:1]
    elif strategy == "random_samples":
        sel = rng.choice(live, size=min(k, len(live)), replace=False)
    elif strategy == "latin_hypercube":
        sel = np.array([rng.choice(s) for s in np.array_split(live, max(k, 1))
                        if len(s)], dtype=np.int64)
    elif strategy == "random_vectors":
        q = rng.standard_normal((max(k, 1), state.dim)).astype(np.float32)
        q = torch.from_numpy(q).to(dev)
        d = state.sq_norms[None, :n] - 2.0 * (q @ state.vectors[:n].float().T)
        d = torch.where(state.valid[None, :n], d, float("inf"))
        sel = torch.argmin(d, dim=1).cpu().numpy()
    else:
        raise ValueError(f"unknown start strategy {strategy!r}")
    return torch.as_tensor(np.unique(sel).astype(np.int32), device=dev)
