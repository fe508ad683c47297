"""Compile a predicate AST to an accept function (PyTorch port of
`diskann_tpu/filters/compile.py`).

The returned callable is ``fn(bits, ids, valid) -> bool mask`` with the
shape of ``ids``: ``bits`` is the ``[cap, n_words]`` int32 bitset of a
`LabelSet`, and the label-to-bit lookup is resolved here, once.  Functions
are cached by (predicate, vocabulary, capacity), so repeated searches with
one predicate reuse one function."""

from __future__ import annotations

from diskann_tpu_torch.filters.predicate import And, Label, Not, Or, Predicate

_CACHE: dict = {}


def _build(pred: Predicate, vocab: dict[str, int]):
    if isinstance(pred, Label):
        if pred.name not in vocab:
            raise KeyError(f"unknown label {pred.name!r}")
        word, bit = divmod(vocab[pred.name], 32)

        def f(bits, safe_ids):
            return ((bits[:, word][safe_ids] >> bit) & 1).bool()

        return f
    if isinstance(pred, And):
        fl, fr = _build(pred.left, vocab), _build(pred.right, vocab)
        return lambda bits, ids: fl(bits, ids) & fr(bits, ids)
    if isinstance(pred, Or):
        fl, fr = _build(pred.left, vocab), _build(pred.right, vocab)
        return lambda bits, ids: fl(bits, ids) | fr(bits, ids)
    if isinstance(pred, Not):
        fi = _build(pred.inner, vocab)
        return lambda bits, ids: ~fi(bits, ids)
    raise TypeError(f"not a predicate: {pred!r}")


def compile_accept(pred: Predicate, vocab: dict[str, int], capacity: int):
    key = (pred, tuple(sorted(vocab.items())), capacity)
    if key in _CACHE:
        return _CACHE[key]
    inner = _build(pred, vocab)

    def accept_fn(bits, ids, valid):
        safe = ids.long().clamp(0, capacity - 1)
        return inner(bits, safe) & valid & (ids >= 0)

    _CACHE[key] = accept_fn
    return accept_fn
