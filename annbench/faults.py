"""Faults planted in the port, for the check that ``correct`` catches
them: each patches `GraphIndex` in this process for the length of a
``with`` block.

- ``insert-noop``: an insert into a built index that acknowledges its
  rows (returns fresh slots) and leaves the index unchanged;
- ``insert-drop``: an insert that acknowledges all its rows and stores all
  but its first minibatch (``insert_batch_size`` rows, at most half of the
  call), handing out slots past the capacity for the rows it dropped,
  which a search never returns and a delete skips;
- ``delete-noop``: a delete that leaves the index unchanged;
- ``half-batch``: a search that answers the first half of its batch and
  leaves the rest out (no ids, infinite distances);
- ``alter-answer``: a search whose first answer has its nearest id
  changed where it is produced.

The exchange between chips is not a fault a one-card cell can have.
"""

from __future__ import annotations

import contextlib

import numpy as np

FAULTS = ("insert-noop", "insert-drop", "delete-noop", "half-batch", "alter-answer")


@contextlib.contextmanager
def planted(name: str):
    from diskann_tpu_torch.graph.index import GraphIndex

    orig = {"insert": GraphIndex.insert, "delete": GraphIndex.delete,
            "search": GraphIndex.search}

    def insert(self, vectors):
        if self.n == 0:     # the build's insert, before the window
            return orig["insert"](self, vectors)
        return np.arange(self.n, self.n + len(vectors), dtype=np.int64)

    dropped = [0]

    def insert_drop(self, vectors):
        if self.n == 0:
            return orig["insert"](self, vectors)
        b = min(self.insert_batch_size, len(vectors) // 2)
        fake = self.state.capacity + dropped[0] + np.arange(b, dtype=np.int64)
        dropped[0] += b
        return np.concatenate([fake, orig["insert"](self, vectors[b:])])

    def delete(self, ids, **kw):
        return None

    def search(self, queries, k=10, **kw):
        d, i, stats = orig["search"](self, queries, k, **kw)
        d, i = d.copy(), i.copy()
        if name == "half-batch":
            half = (i.shape[0] + 1) // 2
            d[half:], i[half:] = np.inf, -1
        else:
            i[0, 0] = (i[0, 0] + 1) % max(self.n, 1)
        return d, i, stats

    patch = {"insert-noop": ("insert", insert), "insert-drop": ("insert", insert_drop),
             "delete-noop": ("delete", delete),
             "half-batch": ("search", search), "alter-answer": ("search", search)}
    if name not in patch:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    attr, fn = patch[name]
    setattr(GraphIndex, attr, fn)
    try:
        yield
    finally:
        setattr(GraphIndex, attr, orig[attr])
