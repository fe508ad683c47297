"""Faults planted in the port, for the check that ``correct`` catches
them: each patches the port in this process for the length of a ``with``
block.

- ``insert-noop``: an insert into a built index that acknowledges its
  rows (returns fresh slots) and leaves the index unchanged;
- ``insert-drop``: an insert that acknowledges all its rows and stores all
  but its first minibatch (``insert_batch_size`` rows, at most half of the
  call), handing out slots past the capacity for the rows it dropped,
  which a search never returns and a delete skips;
- ``delete-noop``: a delete that leaves the index unchanged;
- ``half-batch``: a search (`GraphIndex` or `ShardedGraphIndex`) that
  answers the first half of its batch and leaves the rest out (no ids,
  infinite distances);
- ``alter-answer``: a search (either index) whose first answer has its
  nearest id changed where it is produced;
- ``shard-drop``: a sharded search whose last shard's lists never reach
  the merge (no ids, infinite distances, as from a shard that holds
  nothing).  With overlap every row of that shard lives in another shard
  too, so the other walks can still find it;
- ``exchange-drop``: a sharded search whose merge sees only the lists of
  the mesh's first worker, the one on the merge's own card: the exchange
  between cards left out;
- ``merge-no-dedup``: a sharded search whose merge takes the best k of
  the shards' lists without removing the second copy of a row that two
  shards hold;
- ``filter-ignored``: a label-filtered search (``search_filtered``) that
  answers with the unfiltered search's answer;
- ``and-as-or``: a label-filtered search that evaluates two tags ANDed as
  the two ORed;
- ``short-answer``: a label-filtered search whose every answer has its
  last entry set to -1 (no row, distance inf).

The exchange between cards is not a fault a one-card cell can have.
"""

from __future__ import annotations

import contextlib

import numpy as np

FAULTS = ("insert-noop", "insert-drop", "delete-noop", "half-batch", "alter-answer",
          "shard-drop", "exchange-drop", "merge-no-dedup", "filter-ignored", "and-as-or",
          "short-answer")
# the keyword arguments of search_filtered that the unfiltered search takes too
_SEARCH_KW = ("l_search", "beam_width", "mode", "rerank_l", "max_hops", "query_dtype")


def _searched(name: str, orig):
    """``orig`` (a ``search`` method) with fault ``name`` planted in its answers."""
    def search(self, queries, k=10, **kw):
        d, i, stats = orig(self, queries, k, **kw)
        d, i = d.copy(), i.copy()
        if name == "half-batch":
            half = (i.shape[0] + 1) // 2
            d[half:], i[half:] = np.inf, -1
        else:
            rows = getattr(self, "n", None) or getattr(self, "next_ext", 1)
            i[0, 0] = (i[0, 0] + 1) % max(rows, 1)
        return d, i, stats
    return search


def _filtered(name: str, orig):
    """``orig`` (``GraphIndex.search_filtered``) with fault ``name`` planted;
    a predicate is a string, or a sequence of one a query."""
    def search_filtered(self, queries, predicate, k=10, **kw):
        if name == "filter-ignored":
            return self.search(queries, k, **{a: v for a, v in kw.items() if a in _SEARCH_KW})
        if name == "and-as-or":
            predicate = (predicate.replace("&", "|") if isinstance(predicate, str)
                         else [p.replace("&", "|") for p in predicate])
        d, i, stats = orig(self, queries, predicate, k, **kw)
        if name == "short-answer":
            d, i = d.copy(), i.copy()
            d[:, -1], i[:, -1] = np.inf, -1
        return d, i, stats
    return search_filtered


@contextlib.contextmanager
def planted(name: str):
    import torch

    from diskann_tpu_torch.graph.index import GraphIndex
    from diskann_tpu_torch.parallel import sharded
    from diskann_tpu_torch.parallel.mesh import MeshShards

    orig = {"insert": GraphIndex.insert, "delete": GraphIndex.delete}

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

    walk = MeshShards.walk

    def walk_dropping(self, *a, **kw):
        lists = walk(self, *a, **kw)
        first = next(iter(self.of))       # the worker on the merge's card
        lost = ([len(lists) - 1] if name == "shard-drop" else
                [s for w, ss in self.of.items() if w != first for s in ss])
        for s in lost:
            d, i, c = lists[s]
            lists[s] = (torch.full_like(d, float("inf")), torch.full_like(i, -1), c)
        return lists

    def merge_keeping_copies(all_d, all_i, k):
        s, b, l = all_d.shape
        md = all_d.permute(1, 0, 2).reshape(b, s * l)
        mi = all_i.permute(1, 0, 2).reshape(b, s * l)
        md, order = torch.sort(md, dim=1, stable=True)
        return md[:, :k], torch.gather(mi, 1, order[:, :k])

    patch = {"insert-noop": [(GraphIndex, "insert", insert)],
             "insert-drop": [(GraphIndex, "insert", insert_drop)],
             "delete-noop": [(GraphIndex, "delete", delete)],
             "shard-drop": [(MeshShards, "walk", walk_dropping)],
             "exchange-drop": [(MeshShards, "walk", walk_dropping)],
             "merge-no-dedup": [(sharded, "_merge_topk_dedup", merge_keeping_copies)]}
    for fault in ("half-batch", "alter-answer"):
        patch[fault] = [(cls, "search", _searched(fault, cls.search))
                        for cls in (GraphIndex, sharded.ShardedGraphIndex)]
    for fault in ("filter-ignored", "and-as-or", "short-answer"):
        patch[fault] = [(GraphIndex, "search_filtered",
                         _filtered(fault, GraphIndex.search_filtered))]
    if name not in patch:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patch[name]]
    for owner, attr, fn in patch[name]:
        setattr(owner, attr, fn)
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
