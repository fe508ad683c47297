"""Streaming runbook executor, BigANN format (PyTorch port of
`diskann_tpu/bench/runbook.py`).

A runbook is a list of numbered stages: ``insert`` / ``delete`` ranges over
external ids (tags), ``replace`` (the vectors tagged
``tags_start..tags_end`` are replaced with the dataset rows
``ids_start..ids_end``), ``search`` checkpoints and ``consolidate``.  The
YAML form may nest the stages under a dataset name with its ``max_pts``.

The executor drives a `GraphIndex` through the stages, tracks the tag ->
internal id and tag -> dataset row maps (a replaced tag serves other data
afterwards), and reports recall at every checkpoint against an exact
top-k over the live points, computed by `FlatIndex` on the index's device.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from diskann_tpu_torch.bench.recall import knn_recall
from diskann_tpu_torch.flat.index import FlatIndex
from diskann_tpu_torch.graph.index import GraphIndex


class Runbook(NamedTuple):
    name: str | None
    max_pts: int | None
    steps: list[dict]


def parse_runbook(text_or_obj):
    """Accepts a YAML string, a list of step dicts, or a BigANN-style
    numbered mapping {1: {...}, 2: {...}}; returns the step list.  Use
    `load_runbook` to also recover the dataset name and max_pts."""
    return load_runbook(text_or_obj).steps


def load_runbook(text_or_obj, dataset: str | None = None) -> Runbook:
    """Full BigANN runbook loader: the top level may map dataset names to
    runbook definitions with ``max_pts`` and numbered stages (``gt_url``
    is ignored).  PyYAML is imported only to parse a string."""
    obj = text_or_obj
    if isinstance(obj, str):
        import yaml

        obj = yaml.safe_load(obj)
    name = None
    max_pts = None
    if isinstance(obj, dict):
        numbered = {k: v for k, v in obj.items() if str(k).isdigit()}
        if not numbered and "steps" not in obj:
            # dataset name -> runbook definition
            if dataset is None:
                if len(obj) != 1:
                    raise ValueError(f"runbook holds {sorted(obj)}; pass dataset=")
                dataset = next(iter(obj))
            name = dataset
            obj = obj[dataset]
            numbered = {k: v for k, v in obj.items() if str(k).isdigit()}
        max_pts = obj.get("max_pts") if isinstance(obj, dict) else None
        if "steps" in obj:
            steps = obj["steps"]
        else:
            keyed = {int(k): v for k, v in numbered.items()}
            steps = [keyed[k] for k in sorted(keyed)]
    else:
        steps = list(obj)
    return Runbook(name, max_pts, steps)


class RunbookExecutor:
    """Drives an index through a streaming churn workload.

    Tags follow the BigANN convention: an ``insert`` stage uses the
    dataset offsets ``start..end`` as both data rows and tags; a
    ``replace`` stage re-points the live tags ``tags_start..tags_end`` at
    the dataset rows ``ids_start..ids_end``.  Every stage's wall time ends
    with the device's queue drained (``_sync``)."""

    def __init__(
        self,
        index: GraphIndex,
        data: np.ndarray,
        queries: np.ndarray,
        *,
        k: int = 10,
        l_search: int | None = None,
        delete_method: str = "scan",
        delete_repair: str = "prune",
        delete_kwargs: dict | None = None,
        search_kwargs: dict | None = None,
    ):
        self.index = index
        self.data = np.asarray(data, np.float32)
        self.queries = np.asarray(queries, np.float32)
        self.k = k
        self.l_search = l_search
        self.delete_method = delete_method
        self.delete_repair = delete_repair
        self.delete_kwargs = dict(delete_kwargs or {})
        self.search_kwargs = dict(search_kwargs or {})
        self.tag_to_id: dict[int, int] = {}   # live tag -> internal id
        self.tag_to_row: dict[int, int] = {}  # live tag -> dataset row served
        self.log: list[dict] = []

    @property
    def live_tags(self) -> set[int]:
        return set(self.tag_to_id)

    def _sync(self):
        """Wait for the index's queued device work, so a stage's wall time
        holds its own work and not the previous stage's."""
        if self.index.device.type == "cuda":
            torch.cuda.synchronize(self.index.device)

    def _delete(self, internal_ids: list[int]):
        self.index.delete(np.array(internal_ids, np.int64),
                          method=self.delete_method, repair=self.delete_repair,
                          **self.delete_kwargs)

    def run(self, steps) -> list[dict]:
        """Run the stages; returns the executor's whole log so far (one
        entry per stage: operation, count, recall at checkpoints, wall_s)."""
        steps = parse_runbook(steps)
        self._sync()
        for i, step in enumerate(steps):
            op = step["operation"]
            t0 = time.time()
            entry = {"step": i, "operation": op}
            if op == "insert":
                tags = list(range(int(step["start"]), int(step["end"])))
                ids = self.index.insert(self.data[tags])
                for t, iid in zip(tags, ids):
                    self.tag_to_id[t] = int(iid)
                    self.tag_to_row[t] = t
                entry["count"] = len(ids)
            elif op == "delete":
                tags = [t for t in range(int(step["start"]), int(step["end"]))
                        if t in self.tag_to_id]
                if tags:
                    self._delete([self.tag_to_id[t] for t in tags])
                for t in tags:
                    del self.tag_to_id[t]
                    del self.tag_to_row[t]
                entry["count"] = len(tags)
            elif op == "replace":
                # delete the tags' old ids, insert the new rows, keep the
                # tags (the slots come back through the freelist)
                t0r, t1r = int(step["tags_start"]), int(step["tags_end"])
                r0, r1 = int(step["ids_start"]), int(step["ids_end"])
                if t1r - t0r != r1 - r0:
                    raise ValueError(f"replace ranges differ in length: {step}")
                pairs = [(t, r0 + (t - t0r)) for t in range(t0r, t1r)
                         if t in self.tag_to_id]
                if pairs:
                    self._delete([self.tag_to_id[t] for t, _ in pairs])
                    ids = self.index.insert(self.data[[r for _, r in pairs]])
                    for (t, r), iid in zip(pairs, ids):
                        self.tag_to_id[t] = int(iid)
                        self.tag_to_row[t] = r
                entry["count"] = len(pairs)
            elif op == "consolidate":
                self.index.consolidate()
            elif op == "search":
                entry["recall"] = self._checkpoint_recall()
            else:
                raise ValueError(f"unknown runbook operation {op!r}")
            self._sync()
            entry["wall_s"] = round(time.time() - t0, 4)
            self.log.append(entry)
        return self.log

    def _checkpoint_recall(self) -> float:
        tags = sorted(self.tag_to_id)
        if not tags:
            return 0.0
        rows = np.array([self.tag_to_row[t] for t in tags])
        flat = FlatIndex(self.data[rows], self.index.metric, device=self.index.device)
        k = min(self.k, len(tags))
        _, gt_local = flat.search(self.queries, k=k)
        del flat
        # local flat positions -> internal ids
        internal = np.array([self.tag_to_id[t] for t in tags])
        gt_ids = np.where(gt_local >= 0,
                          internal[np.clip(gt_local, 0, len(tags) - 1)], -1)
        l = self.l_search or max(self.index.config.l_build, 2 * k)
        _, ids, _ = self.index.search(self.queries, k=k, l_search=l,
                                      **self.search_kwargs)
        return knn_recall(ids, gt_ids, k)
