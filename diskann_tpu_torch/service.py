"""Vector-set service facade (PyTorch port of `diskann_tpu/service.py`).

Replaces the surface the reference exports to the Garnet server over C FFI
(`diskann-garnet/src/lib.rs:222-835`: create_index / drop_index / insert /
remove / search_vector / search_element / continue_search / set_attribute /
build_quant_table / backfill_quant_vectors / card, serving the Redis
`VADD`/`VSIM` vector-set commands): a small in-process registry of named
dynamic indexes with element-name <-> internal-id mapping and per-element
attributes.  Every index lives on the service's device (the CUDA card
unless the caller names another).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from diskann_tpu_torch.devices import default_device
from diskann_tpu_torch.graph.config import GraphConfig
from diskann_tpu_torch.graph.index import GraphIndex
from diskann_tpu_torch.graph.modes import PagedSearch
from diskann_tpu_torch.graph.scorers import sq_aux_norms, sq_center_codes
from diskann_tpu_torch.ops.distance import Metric


class VectorSet:
    """One named collection (the `VADD`/`VSIM` target)."""

    def __init__(self, dim: int, config: GraphConfig | None = None, **kw):
        # small insert granularity: a single VADD pads to one minibatch, so
        # the padding waste is bounded by this, not the bulk-build 1024
        kw.setdefault("insert_batch_size", 64)
        self.index = GraphIndex(dim, config, **kw)
        self.name_to_id: dict[str, int] = {}
        self.id_to_name: dict[int, str] = {}
        self.attributes: dict[str, Any] = {}
        self.quant_mode: str | None = None
        self._cursors: dict[int, Any] = {}
        self._next_cursor = 0
        # write buffer: single VADDs accumulate host-side and commit as one
        # minibatch at the next read (or when a minibatch fills) — a lone
        # add would otherwise pay a full padded insert_batch dispatch
        self._pending: list[tuple[str, np.ndarray, Any]] = []
        # ids whose labels changed since the last filtered search; applied
        # incrementally via LabelSet.set_labels instead of a full O(capacity)
        # rebuild (None = label set never built yet)
        self._label_dirty_ids: set[int] | None = None

    # VADD
    def add(self, name: str, vector, attribute: Any = None) -> bool:
        if name in self.name_to_id or any(n == name for n, _, _ in self._pending):
            return False  # reference semantics: element ids are unique
        self._pending.append((name, np.asarray(vector, np.float32), attribute))
        if len(self._pending) >= self.index.insert_batch_size:
            try:
                self._flush()
            except BaseException:
                # this add is answered with the error: drop it, keep the rest
                self._pending.pop()
                raise
        return True

    def _flush(self) -> None:
        """Commit buffered VADDs as one insert minibatch.  An insert that
        raises commits nothing (`GraphIndex.insert`), so the buffered
        VADDs stay buffered for the next flush (the reference drops
        them)."""
        if not self._pending:
            return
        pend, self._pending = self._pending, []
        try:
            ids = self.index.insert(np.stack([v for _, v, _ in pend]))
        except BaseException:
            self._pending = pend
            raise
        for (name, _, attr), iid in zip(pend, ids):
            self._bind(name, int(iid), attr)
        if self.quant_mode is not None:
            self._encode_rows(np.asarray(ids))

    def _bind(self, name: str, iid: int, attr: Any) -> None:
        """Map a committed element's name and id, keep its attribute."""
        self.name_to_id[name] = iid
        self.id_to_name[iid] = name
        if attr is not None:
            self.attributes[name] = attr
        self._mark_label_dirty(iid)

    def _mark_label_dirty(self, iid: int) -> None:
        if self._label_dirty_ids is not None:
            self._label_dirty_ids.add(iid)

    def add_batch(self, names, vectors, attributes=None) -> int:
        """Batched VADD — the streaming-server fast path (one device
        dispatch per minibatch instead of one per element)."""
        vectors = np.asarray(vectors, np.float32)
        fresh = [i for i, n in enumerate(names) if n not in self.name_to_id]
        if not fresh:
            return 0
        ids = self.index.insert(vectors[fresh])
        for j, i in enumerate(fresh):
            self._bind(names[i], int(ids[j]),
                       attributes[i] if attributes is not None else None)
        if self.quant_mode is not None:
            self._encode_rows(np.asarray(ids))
        return len(fresh)

    # VREM
    def remove(self, name: str) -> bool:
        for j, (n, _, _) in enumerate(self._pending):
            if n == name:           # buffered, never committed: drop it
                self._pending.pop(j)
                return True
        iid = self.name_to_id.get(name)
        if iid is None:
            return False
        # unbound only once the delete commits: a delete that raises leaves
        # the index as it was, so the element stays (the reference unbinds
        # first, and a second VREM then answers 0 and deletes nothing)
        self.index.delete([iid])
        del self.name_to_id[name]
        self.id_to_name.pop(iid, None)
        self.attributes.pop(name, None)
        self._mark_label_dirty(iid)
        return True

    # ------------------------------------------------------- dynamic quant
    def build_quant_table(self, kind: str = "spherical", **kw) -> None:
        """Train a quantizer over the CURRENT elements (reference
        `build_quant_table`, `diskann-garnet/src/quantization.rs`): after
        this, `backfill_quant_vectors` encodes existing rows and subsequent
        adds are encoded incrementally, so searches can run quantized."""
        self._flush()
        attach = {"spherical": self.index.attach_spherical, "sq": self.index.attach_sq,
                  "minmax": self.index.attach_minmax}.get(kind)
        if attach is None:
            raise ValueError(f"unsupported quant kind {kind!r}")
        attach(**kw)
        self.quant_mode = kind

    def backfill_quant_vectors(self) -> int:
        """Re-encode every current element with the trained quantizer
        (reference `backfill_quant_vectors`).  attach_* already encodes all
        rows present at training time; this re-encodes to cover rows added
        between training and backfill."""
        if self.quant_mode is None:
            raise ValueError("no quant table built")
        self._flush()
        ids = np.fromiter(self.id_to_name, np.int64, len(self.id_to_name))
        self._encode_rows(ids)
        return len(ids)

    def _encode_rows(self, ids: np.ndarray) -> None:
        """Encode rows `ids` into the attached code tables in place (the
        fixed trained transform applies per row, so streaming adds never
        retrain)."""
        idx = self.index
        rows = torch.as_tensor(np.asarray(ids, np.int64), device=idx.device)
        vecs = idx.state.vectors[rows]
        if self.quant_mode == "spherical":
            pc = idx.sph.pack(idx.sph.encode(vecs))
            idx.sph_words[rows] = pc.words
            idx.sph_norms[rows] = pc.norms
            idx.sph_cscale[rows] = pc.cscale
        elif self.quant_mode == "sq":
            ci8, _ = sq_center_codes(idx.sq.encode(vecs), idx.sq.scale, idx.sq.bias)
            idx.sq_codes[rows] = ci8
            idx.sq_aux[rows] = sq_aux_norms(ci8, idx.sq.scale)
        elif self.quant_mode == "minmax":
            codes, lo, step = idx.mm.encode(vecs)
            dec = idx.mm.decode(codes, lo, step)
            idx.mm_codes[rows] = (codes.to(torch.int32) - 128).to(torch.int8)
            idx.mm_lo[rows] = lo
            idx.mm_step[rows] = step
            idx.mm_aux[rows] = (dec * dec).sum(1)

    # ------------------------------------------------------------- search
    def _search_mode(self, mode: str | None) -> str:
        # no quantizer -> mode="auto": the index routes small sets to the
        # exact flat scan and large ones to the graph, so the caller never
        # has to choose
        return mode if mode is not None else (self.quant_mode or "auto")

    def _named(self, ids, dists) -> list:
        return [(self.id_to_name[int(i)], float(dd)) for i, dd in zip(ids, dists)
                if int(i) in self.id_to_name]

    # VSIM with a query vector
    def search_vector(self, vector, k: int = 10, *,
                      l_search: int | None = None, mode: str | None = None):
        self._flush()
        d, ids, _ = self.index.search(
            np.asarray(vector, np.float32)[None], k=k, l_search=l_search,
            mode=self._search_mode(mode),
        )
        return self._named(ids[0], d[0])

    # VSIM ... FILTER (reference `filtered_search_vector`, lib.rs:623-667:
    # inline filtered search with AdaptiveL capped by max_filtering_effort)
    def search_vector_filtered(self, vector, predicate, k: int = 10, *,
                               l_search: int | None = None,
                               max_filtering_effort: int = 8):
        """Filtered VSIM: elements whose ATTRIBUTE is a label string (or a
        list of label strings) are matched against `predicate`
        ("a & !b" syntax); unlabeled elements never match.
        max_filtering_effort caps the AdaptiveL re-search scale."""
        self._flush()
        self._sync_labels()
        d, ids, _ = self.index.search_filtered(
            np.asarray(vector, np.float32)[None], predicate, k=k,
            l_search=l_search, max_l_scale=max_filtering_effort,
        )
        return self._named(ids[0], d[0])

    def _labels_of(self, iid: int) -> list[str]:
        a = self.attributes.get(self.id_to_name.get(iid, ""))
        if isinstance(a, str):
            return [a]
        if isinstance(a, (list, tuple)) and a and all(isinstance(s, str) for s in a):
            return list(a)
        return []

    def _sync_labels(self) -> None:
        """Bring the index's LabelSet up to date.  First filtered search
        builds it in full; afterwards only ids touched by add/remove/
        set_attribute re-encode, via the incremental `LabelSet.set_labels`
        device scatter (O(dirty) instead of O(capacity))."""
        if self._label_dirty_ids is None:
            lists: list[list[str]] = [[] for _ in range(self.index.state.capacity)]
            for iid in self.name_to_id.values():
                lists[iid] = self._labels_of(iid)
            self.index.attach_labels(lists)
            self._label_dirty_ids = set()
        elif self._label_dirty_ids:
            ids = np.fromiter(self._label_dirty_ids, np.int64, len(self._label_dirty_ids))
            self.index.labels.set_labels(ids, [self._labels_of(int(i)) for i in ids])
            self._label_dirty_ids.clear()

    # VSIM with an element name
    def search_element(self, name: str, k: int = 10, **kw):
        self._flush()
        vec = self.index.state.vectors[self.name_to_id[name]].cpu().numpy()
        out = self.search_vector(vec, k + 1, **kw)
        return [(n, d) for n, d in out if n != name][:k]

    # paged search over the service contract (`lib.rs:752` continue_search)
    def start_search(self, vector, page_size: int = 10, *,
                     l_search: int | None = None) -> tuple[int, list]:
        """Begin a resumable search; returns (cursor, first page)."""
        self._flush()
        pager = PagedSearch(self.index, np.asarray(vector, np.float32), l_search=l_search)
        cursor = self._next_cursor
        self._next_cursor += 1
        self._cursors[cursor] = pager
        return cursor, self.continue_search(cursor, page_size)

    def continue_search(self, cursor: int, page_size: int = 10) -> list:
        """Next page of a search started with `start_search`; an empty page
        ends (and frees) the cursor — reference `continue_search`."""
        pager = self._cursors.get(cursor)
        if pager is None:
            return []
        d, ids = pager.next_page(page_size)
        if len(ids) == 0:
            self._cursors.pop(cursor, None)
        return self._named(ids, d)

    def end_search(self, cursor: int) -> bool:
        return self._cursors.pop(cursor, None) is not None

    def set_attribute(self, name: str, attribute: Any) -> bool:
        for j, (n, v, _) in enumerate(self._pending):
            if n == name:
                self._pending[j] = (n, v, attribute)
                return True
        if name not in self.name_to_id:
            return False
        self.attributes[name] = attribute
        self._mark_label_dirty(self.name_to_id[name])
        return True

    def get_attribute(self, name: str) -> Any:
        for n, _, a in self._pending:
            if n == name:
                return a
        return self.attributes.get(name)

    # CARD
    def card(self) -> int:
        return len(self.name_to_id) + len(self._pending)


class VectorService:
    """Named-index registry (create_index / drop_index / ...).  Indexes
    live on ``device`` (the CUDA card by default) unless `create_index`
    names another."""

    def __init__(self, device=None):
        self.device = default_device(device)
        self._sets: dict[str, VectorSet] = {}

    def create_index(
        self, name: str, dim: int, *, metric: str = "l2",
        max_degree: int = 32, l_build: int = 64, device=None, **kw,
    ) -> VectorSet:
        if name in self._sets:
            raise KeyError(f"index {name!r} exists")
        cfg = GraphConfig(max_degree=max_degree, l_build=l_build, metric=Metric(metric))
        vs = VectorSet(dim, cfg, device=device if device is not None else self.device, **kw)
        self._sets[name] = vs
        return vs

    def drop_index(self, name: str) -> bool:
        return self._sets.pop(name, None) is not None

    def get(self, name: str) -> VectorSet:
        return self._sets[name]

    def names(self) -> list[str]:
        return sorted(self._sets)
