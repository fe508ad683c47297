"""Per-point label storage as a dense device bitset (PyTorch port of
`diskann_tpu/filters/labels.py`).

One bitset row per point, ``[cap, n_words]``: a label test for a ``[B, C]``
candidate batch is one row gather plus bit operations.

The words are stored as ``torch.int32`` holding the reference's uint32 bit
patterns: torch has no shifts on ``uint32`` on the CPU.  A bit is tested
with ``(w >> bit) & 1``; the arithmetic shift of a negative word fills with
ones, which the ``& 1`` discards.
"""

from __future__ import annotations

import numpy as np
import torch


def _rows(labels_per_point, vocab: dict[str, int], n_rows: int, n_words: int):
    """Host bitset rows [n_rows, n_words] as int32 words."""
    rows = np.zeros((n_rows, n_words), np.uint32)
    for i, ls in enumerate(labels_per_point):
        for label in ls:
            b = vocab[label]
            rows[i, b // 32] |= np.uint32(1 << (b % 32))
    return rows.view(np.int32)


class LabelSet:
    """Mutable label assignment for up to `capacity` points."""

    def __init__(self, capacity: int, vocab: dict[str, int] | None = None,
                 n_words: int = 4, device=None):
        self.capacity = capacity
        self.vocab: dict[str, int] = dict(vocab or {})
        self.n_words = n_words
        self.bits = torch.zeros((capacity, n_words), dtype=torch.int32,
                                device=device)
        self.version = 0   # bumped on every mutation (cache invalidation)

    @classmethod
    def from_lists(cls, labels_per_point: list[list[str]],
                   capacity: int | None = None, device=None):
        """Build from per-point label lists (the JSONL ingestion shape)."""
        capacity = capacity or len(labels_per_point)
        vocab: dict[str, int] = {}
        for ls in labels_per_point:
            for label in ls:
                if label not in vocab:
                    vocab[label] = len(vocab)
        n_words = max(1, -(-len(vocab) // 32))
        out = cls(capacity, vocab, n_words, device=device)
        out.bits = torch.from_numpy(
            _rows(labels_per_point, vocab, capacity, n_words)
        ).to(device)
        return out

    def _bit(self, label: str) -> int:
        if label not in self.vocab:
            raise KeyError(f"unknown label {label!r}")
        return self.vocab[label]

    def add_label(self, label: str) -> int:
        if label in self.vocab:
            return self.vocab[label]
        b = len(self.vocab)
        if b >= self.n_words * 32:
            # grow the word capacity
            extra = self.n_words
            self.bits = torch.nn.functional.pad(self.bits, (0, extra))
            self.n_words += extra
        self.vocab[label] = b
        return b

    def set_labels(self, ids, labels_per_id: list[list[str]]):
        """Replace the labels of `ids`.  Ids outside [0, capacity) are
        dropped (the reference drops those past the end)."""
        # grow the vocab first (a mid-loop word growth would outdate rows)
        for ls in labels_per_id:
            for label in ls:
                self.add_label(label)
        rows = torch.from_numpy(
            _rows(labels_per_id, self.vocab, len(labels_per_id), self.n_words)
        ).to(self.bits.device)
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                              device=self.bits.device)
        keep = (ids >= 0) & (ids < self.capacity)
        self.bits[ids[keep]] = rows[keep]
        self.version += 1

    def test(self, label: str, ids: torch.Tensor) -> torch.Tensor:
        """Device bit test: which of `ids` carry `label`."""
        word, bit = divmod(self._bit(label), 32)
        safe = ids.long().clamp(0, self.capacity - 1)
        w = self.bits[:, word][safe]
        return ((w >> bit) & 1).bool() & (ids >= 0)

    def members(self, label: str) -> np.ndarray:
        """Inverted-index view: ids carrying `label` (host side)."""
        word, bit = divmod(self._bit(label), 32)
        col = self.bits[:, word].cpu().numpy()
        return np.nonzero((col >> bit) & 1)[0]
