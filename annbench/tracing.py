"""The traced sub-window of a ``--trace 1`` run.

`Traced` runs torch.profiler (host and device activity) over the
sub-window, and for its length installs the benchmark's own wrappers where
the port's callers look its functions up:

- ``graph.index.beam_search_scored`` inside a ``annbench.walk`` range, so
  the hop loop's device time can be read off the range;
- ``graph.scorers.fatrow_expand`` (K1) and ``graph.packed.block_patch``
  (K2), recording each call's arguments for the byte counts of
  `annbench.roofline`.

A name the port no longer has is left alone and noted in ``missing``; the
readers that need it then report nothing.  After the window `summary`
reduces the trace (`reduce_profile`): the device's busy time (the union of
its kernel and copy spans), kernel counts and times by name, the device
time inside each host-side range or op (the benchmark's and any the port
opens), and the longest idle gaps, each named by what the host was doing
then.

A system whose index lives in mesh workers (`annbench.system.Sharded`)
passes its ``on_cards``: each worker then runs torch.profiler of its own
over the sub-window (`worker_trace_start` / `worker_trace_stop`, started
before the caller's profile and stopped after it), wraps K1 there as the
caller does, and reduces its trace and K1's byte counts where it ran;
`summary` puts the cards' results under ``cards``.

`HostSpans` times every call of some of the port's functions on the host
clock, for as long as its ``with`` block runs (the run holds it over the
whole window).
"""

from __future__ import annotations

import functools
import importlib
import statistics
import time

import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from annbench.roofline import k1_bound

RANGE_PREFIX = "annbench."
_COPIES = ("Memcpy", "Memset")
# device ops and idle gaps kept in a summary
TOP = 10
# top-level module names that no process of a run may load: JAX's and the
# JAX package's (``diskann_tpu_torch`` is neither)
FORBIDDEN = ("jax", "jaxlib", "flax", "diskann_tpu")


def _device_us(e, total: bool = False) -> float:
    """Device microseconds of a `key_averages` entry (self, or with children)."""
    name = "device_time_total" if total else "self_device_time_total"
    old = "cuda_time_total" if total else "self_cuda_time_total"
    return float(getattr(e, name, getattr(e, old, 0)))


class Traced:
    def __init__(self, device: torch.device, on_cards=None):
        self.device = device
        self.on_cards = on_cards  # runs a function in every mesh worker, or None
        self.cards = None         # each worker's reduced trace, by card
        self.k1_calls: list[tuple] = []   # (beam ids, table word rows, rp, dp)
        self.k2_calls: list[tuple] = []   # (block ids, table blocks, block bytes)
        self.missing: list[str] = []
        self.wall_s = 0.0
        self.queries = 0      # queries answered in the sub-window
        self._saved: list[tuple] = []

    # ------------------------------------------------------------ wrappers
    def _wrap(self, module: str, attr: str, make) -> None:
        mod = importlib.import_module(module)
        orig = getattr(mod, attr, None)
        if orig is None:
            self.missing.append(f"{module}.{attr}")
            return
        self._saved.append((mod, attr, orig))
        setattr(mod, attr, make(orig))

    def _walk(self, orig):
        def beam_search_scored(*a, **kw):
            with record_function(RANGE_PREFIX + "walk"):
                return orig(*a, **kw)
        return beam_search_scored

    def _k1(self, orig):
        return _k1_recorder(orig, self.k1_calls)

    def _k2(self, orig):
        calls = self.k2_calls

        def block_patch(table, block_idx, vals):
            out = orig(table, block_idx, vals)
            calls.append((block_idx, table.shape[0] // 8, 8 * 128 * table.element_size()))
            return out
        return block_patch

    def __enter__(self):
        if self.on_cards is not None:
            self.on_cards(worker_trace_start)
        self._wrap("diskann_tpu_torch.graph.index", "beam_search_scored", self._walk)
        self._wrap("diskann_tpu_torch.graph.scorers", "fatrow_expand", self._k1)
        self._wrap("diskann_tpu_torch.graph.packed", "block_patch", self._k2)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.wall_s = time.perf_counter() - self._t0
        finally:
            self._prof.__exit__(*exc)
            for mod, attr, orig in reversed(self._saved):
                setattr(mod, attr, orig)
            if self.on_cards is not None:
                self.cards = self.on_cards(worker_trace_stop, TOP)
        return False

    # ------------------------------------------------------------- reduce
    def summary(self, top: int = TOP) -> dict:
        """The trace reduced to what the per-layer readers and the result's
        ``device`` and ``breakdown`` need; seconds throughout.

        ``k1_bounds`` lists (bytes, int8 operations) of each K1 call
        (`annbench.roofline.k1_bound`).

        With mesh workers: ``cards`` holds each card's ``busy_s`` (its
        worker's, and on the caller's own card the caller's too: the merge,
        which starts once every worker has replied, so the two never
        overlap), ``wall_s`` (the caller's sub-window), ``kernels`` and
        ``kernel_s`` (its worker's); ``busy_s`` becomes the cards' mean
        (the caller's own is kept as ``caller_busy_s``), ``kernel_s`` and
        ``k1_bounds`` take in every worker's, and ``device_ops`` and
        ``idle_gaps`` are the longest over every card, each named
        ``<card>/...``."""
        out = {"wall_s": self.wall_s, **reduce_profile(self._prof, top),
               "k1_bounds": [k1_bound(*c) for c in self.k1_calls]}
        if self.cards is None:
            return out
        own = f"{self.device.type}:{self.device.index or 0}"
        cards = {c: {"busy_s": w["busy_s"] + (out["busy_s"] if c == own else 0.0),
                     "wall_s": self.wall_s, "kernels": w["kernels"], "kernel_s": w["kernel_s"]}
                 for c, w in self.cards.items()}
        kernel_s = dict(out["kernel_s"])
        for w in self.cards.values():
            for n, t in w["kernel_s"].items():
                kernel_s[n] = kernel_s.get(n, 0.0) + t
        ops = [[f"{c}/{n}"[:120], s] for c, w in self.cards.items() for n, s in w["device_ops"]]
        ops += [[f"{own}/caller/{n}"[:120], s] for n, s in out["device_ops"]]
        gaps = [[f"{c}/{n.removeprefix('outside / ')}"[:120], s]
                for c, w in self.cards.items() for n, s in w["idle_gaps"]]
        out.update(cards=cards, caller_busy_s=out["busy_s"], kernel_s=kernel_s,
                   k1_bounds=out["k1_bounds"] + [b for w in self.cards.values()
                                                 for b in w["k1_bounds"]],
                   busy_s=statistics.fmean(v["busy_s"] for v in cards.values()),
                   device_ops=sorted(ops, key=lambda t: -t[1])[:top],
                   idle_gaps=sorted(gaps, key=lambda t: -t[1])[:top])
        return out


def reduce_profile(prof, top: int) -> dict:
    """A finished torch.profiler profile reduced: the device's busy time
    (the union of its kernel and copy spans), kernel counts and times by
    name, the device time inside each host-side range or op, the ``top``
    device ops and the ``top`` longest idle gaps; seconds throughout."""
    dev_type = torch.autograd.DeviceType.CUDA
    events = prof.events()
    dev = [e for e in events if e.device_type == dev_type
           and not e.name.startswith(RANGE_PREFIX)]
    host = [e for e in events if e.device_type != dev_type]
    kernels = [e for e in dev if not e.name.startswith(_COPIES)]
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    merged: list[list[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e6
    ranges = {}   # host-side events (ranges, ops): device time inside each
    for e in prof.key_averages():
        us = _device_us(e, total=True)
        if e.device_type != dev_type and us > 0:
            ranges[e.key] = ranges.get(e.key, 0.0) + us / 1e6
    return {
        "busy_s": busy, "kernels": len(kernels),
        "kernel_s": by_name, "ranges_device_s": ranges,
        "device_ops": sorted(([n[:120], s] for n, s in by_name.items()),
                             key=lambda t: -t[1])[:top],
        "idle_gaps": _gaps(merged, host, top),
    }


def _gaps(merged: list, host: list, top: int) -> list:
    """The ``top`` longest gaps between device spans, each named by the
    benchmark range and the innermost host event open at its middle."""
    if len(merged) < 2 or not host:
        return []
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:top]
    start = np.array([e.time_range.start for e in host], np.float64)
    end = np.array([e.time_range.end for e in host], np.float64)
    is_range = np.array([e.name.startswith(RANGE_PREFIX) for e in host])
    out = []
    for length, a in gaps:
        mid = a + length / 2
        open_ = (start <= mid) & (end >= mid)
        where = "outside"
        if (open_ & is_range).any():
            i = np.flatnonzero(open_ & is_range)
            where = host[int(i[np.argmin(end[i] - start[i])])].name
        what = "idle host"
        if (open_ & ~is_range).any():
            i = np.flatnonzero(open_ & ~is_range)
            what = host[int(i[np.argmin(end[i] - start[i])])].name
        out.append([f"{where} / {what}"[:120], length / 1e6])
    return out


class HostSpans:
    """Host-clock spans around every call of some of the port's functions
    while the ``with`` block runs.  ``targets``: (module, "function" or
    "Class.method", span name); ``spans[name]`` lists each call's
    (start, end) `time.perf_counter` readings.  A name the port no longer
    has is left alone and noted in ``missing``."""

    def __init__(self, targets=()):
        self.targets = tuple(targets)
        self.spans: dict[str, list] = {name: [] for _, _, name in self.targets}
        self.missing: list[str] = []
        self._saved: list[tuple] = []

    def within(self, name: str, lo: float, hi: float) -> list:
        """The spans of ``name`` that lie inside [lo, hi]."""
        return [(a, b) for a, b in self.spans.get(name, []) if a >= lo and b <= hi]

    def __enter__(self):
        for module, path, name in self.targets:
            owner = importlib.import_module(module)
            *outer, attr = path.split(".")
            for part in outer:
                owner = getattr(owner, part, None)
            orig = getattr(owner, attr, None) if owner is not None else None
            if orig is None:
                self.missing.append(f"{module}.{path}")
                continue
            self._saved.append((owner, attr, orig))
            setattr(owner, attr, _timed(orig, self.spans[name]))
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved.clear()
        return False


def calls_and_spans(run, name: str) -> tuple[int, list]:
    """(the window's search calls, the spans of ``name`` that lie inside
    the window), from the run's `HostSpans`; (0, []) without either."""
    window = run.window["spans"]
    host = getattr(run, "host_spans", None)
    calls = sum(op == "search" for op, _, _, _ in window)
    if not calls or host is None:
        return 0, []
    return calls, host.within(name, window[0][1], window[-1][2])


def _k1_recorder(orig, calls: list):
    """``orig`` (K1) that records each call's (beam ids, table word rows,
    rp, dp) in ``calls``."""
    def fatrow_expand(rows, beam_flat, qiw, *, rp, dp):
        out = orig(rows, beam_flat, qiw, rp=rp, dp=dp)
        calls.append((beam_flat, rows.shape[0], rp, dp))
        return out
    return fatrow_expand


def forbidden_modules() -> list[str]:
    """Loaded modules of this process whose top-level name, compared
    whole, is in ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _timed(fn, out: list):
    @functools.wraps(fn)
    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            out.append((t0, time.perf_counter()))
    return timed


# ------------------------------------------------ what runs in a mesh worker
# Each worker process holds at most one profile, and K1's wrapper, between
# the two commands of one traced sub-window.
_WORKER_PROFILE: dict = {}
_K1_MODULE = "diskann_tpu_torch.graph.scorers"


def worker_trace_start() -> None:
    """Start torch.profiler in this mesh worker (device activity too where
    the worker has reached a card), and record K1's calls."""
    mod = importlib.import_module(_K1_MODULE)
    orig, calls = getattr(mod, "fatrow_expand", None), []
    if orig is not None:
        mod.fatrow_expand = _k1_recorder(orig, calls)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    _WORKER_PROFILE.update(prof=prof, k1=(mod, orig, calls))


def worker_trace_stop(top: int) -> dict:
    """Wait for this worker's card, end its profile, put K1 back, and
    reduce the profile (`reduce_profile`) and K1's calls (``k1_bounds``)
    here."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof = _WORKER_PROFILE.pop("prof")
    prof.__exit__(None, None, None)
    mod, orig, calls = _WORKER_PROFILE.pop("k1")
    if orig is not None:
        mod.fatrow_expand = orig
    return {**reduce_profile(prof, top), "k1_bounds": [k1_bound(*c) for c in calls]}


def worker_peak_bytes() -> int:
    """This mesh worker's ``max_memory_allocated`` on its card (0 on the CPU)."""
    return torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else 0
