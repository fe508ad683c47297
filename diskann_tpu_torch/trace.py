"""The port's tracing: spans and counters at the boundaries of its work,
stamped on the profiler's clock.

The reference integrates the `tracing` crate with caller-location fields
(`diskann/src/tracing.rs:6-50`) and exports OpenTelemetry spans to JSON
from the disk benchmark (`diskann-benchmark/src/disk_index/
json_spancollector.rs`).  Here:

- `span(name, **attributes)` brackets a phase of host orchestration: a
  search call and its router, walk and rerank; an insert minibatch and its
  candidate walk and edge commit; a delete call and its repair and fat-row
  refresh; the tiered pipeline's walks, gather waits, uploads and reranks.
- `wait(name)` brackets a block in which the host waits on the card (the
  counter ``sync``: each hop flag read, each lockstep round's flags, the
  answers' copy back).

Off (the default), `span` and `wait` test two module flags and return one
shared no-op context manager.  `enable()` records each span in memory:
``id``, ``parent``, ``trace`` (its root span's id, shared by every span of
one call), ``name``, ``start_ns`` / ``end_ns`` (`time.time_ns()`, the unix
clock the profiler stamps its trace start with) and ``attributes``; and
each counter's count and nanoseconds.  While a `torch.profiler` runs, every
span and wait also opens a profiler range of its name for its length,
whether or not `enable()` was called, so the kernels it launches sit under
the port's phase in the trace.  The range is a function-scope one, not a
user annotation: Kineto gives it no device-side twin, so a reader that
counts device events counts kernels and copies only.

A span nests under the innermost open span of its thread.  Generators that
one thread steps in turn (`parallel/sharded._fan_out`) each take a stack of
their own (`fork`, `resume`); every span closes its own record, so spans
of interleaved generators stay nested under their own generator's spans.
Their profiler ranges, though, overlap on the one thread.

Usage:
    from diskann_tpu_torch import trace
    trace.enable(True)
    with trace.span("build.batch", batch=3, points=8192):
        ...
    trace.export_spans("trace.json")   # {"spans": [...], "counters": {...}}
"""

from __future__ import annotations

import itertools
import json
import threading
import time

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

_enabled = False   # opt-in: enable() / the bench CLI --trace flag
_tls = threading.local()
_ids = itertools.count(1)
_lock = threading.Lock()
_all_spans: list[dict] = []
_counters: dict[str, list[int]] = {}   # name -> [count, ns]


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = bool(on)


def _stack() -> list:
    stk = getattr(_tls, "stack", None)
    if stk is None:
        stk = _tls.stack = []
    return stk


def _range(name: str):
    """An open profiler range of ``name`` while a profiler runs, else None."""
    if not _profiler._is_profiler_enabled:
        return None
    r = _RecordFunctionFast(name)
    r.__enter__()
    return r


class _Span:
    __slots__ = ("rec", "stack", "range")

    def __init__(self, name: str, attributes: dict):
        self.rec = {"id": None, "parent": None, "trace": None, "name": name,
                    "start_ns": None, "end_ns": None, "attributes": attributes}

    def __enter__(self):
        rec = self.rec
        stk = self.stack = _stack()
        top = stk[-1] if stk else None
        rec["id"] = next(_ids)
        rec["parent"] = top["id"] if top else None
        rec["trace"] = top["trace"] if top else rec["id"]
        stk.append(rec)
        rec["start_ns"] = time.time_ns()
        self.range = _range(rec["name"])
        return rec

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(None, None, None)
        rec = self.rec
        rec["end_ns"] = time.time_ns()
        rec["duration_ms"] = round((rec["end_ns"] - rec["start_ns"]) / 1e6, 4)
        stk = self.stack
        for j in range(len(stk) - 1, -1, -1):   # its own record, wherever it is
            if stk[j] is rec:
                del stk[j]
                break
        with _lock:
            _all_spans.append(rec)
        return False


def span(name: str, **attributes):
    """A context manager bracketing one phase (see the module's docstring);
    entered, it gives the span's record, or None while tracing is off."""
    if not _enabled:
        return _RecordFunctionFast(name) if _profiler._is_profiler_enabled else _NOOP
    return _Span(name, attributes)


class _Wait:
    __slots__ = ("name", "t0", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = _range(self.name)
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        ns = time.time_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(None, None, None)
        with _lock:
            c = _counters.setdefault(self.name, [0, 0])
            c[0] += 1
            c[1] += ns
        return False


def wait(name: str):
    """A context manager around a block in which the host waits: adds one
    to counter ``name`` and the block's nanoseconds."""
    if not _enabled:
        return _RecordFunctionFast(name) if _profiler._is_profiler_enabled else _NOOP
    return _Wait(name)


def counters() -> dict:
    """{name: {"count": ..., "ns": ...}} of every counter since the last
    `clear_spans`."""
    with _lock:
        return {k: {"count": c, "ns": ns} for k, (c, ns) in _counters.items()}


def fork(n: int):
    """Span stacks for ``n`` generators that one thread steps in turn, each
    starting under the caller's open span; None while tracing is off."""
    if not _enabled:
        return None
    base = _stack()
    return [list(base) for _ in range(n)]


class _Resume:
    __slots__ = ("stack", "saved")

    def __init__(self, stack: list):
        self.stack = stack

    def __enter__(self):
        self.saved = getattr(_tls, "stack", None)
        _tls.stack = self.stack

    def __exit__(self, *exc):
        _tls.stack = self.saved
        return False


def resume(stacks, i: int):
    """A context manager that makes stack ``i`` of `fork`'s ``stacks`` the
    thread's for its body (a no-op for None)."""
    return _NOOP if stacks is None else _Resume(stacks[i])


def spans() -> list[dict]:
    with _lock:
        return list(_all_spans)


def clear_spans() -> None:
    """Forget every span and counter recorded so far."""
    with _lock:
        _all_spans.clear()
        _counters.clear()


def export_spans(path: str) -> int:
    """Write the spans and counters as JSON (json_spancollector.rs
    analogue).  Returns the span count."""
    data, cnt = spans(), counters()
    with open(path, "w") as f:
        json.dump({"spans": data, "counters": cnt}, f, indent=1)
    return len(data)
