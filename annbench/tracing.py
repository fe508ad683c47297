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
reduces the trace: the device's busy time (the union of its kernel and
copy spans), kernel counts and times by name, the device time inside each
host-side range or op (the benchmark's and any the port opens),
and the longest idle gaps, each named by what the host was doing then.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

RANGE_PREFIX = "annbench."
_COPIES = ("Memcpy", "Memset")


def _device_us(e, total: bool = False) -> float:
    """Device microseconds of a `key_averages` entry (self, or with children)."""
    name = "device_time_total" if total else "self_device_time_total"
    old = "cuda_time_total" if total else "self_cuda_time_total"
    return float(getattr(e, name, getattr(e, old, 0)))


class Traced:
    def __init__(self, device: torch.device):
        self.device = device
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
        calls = self.k1_calls

        def fatrow_expand(rows, beam_flat, qiw, *, rp, dp):
            out = orig(rows, beam_flat, qiw, rp=rp, dp=dp)
            calls.append((beam_flat, rows.shape[0], rp, dp))
            return out
        return fatrow_expand

    def _k2(self, orig):
        calls = self.k2_calls

        def block_patch(table, block_idx, vals):
            out = orig(table, block_idx, vals)
            calls.append((block_idx, table.shape[0] // 8, 8 * 128 * table.element_size()))
            return out
        return block_patch

    def __enter__(self):
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
        return False

    # ------------------------------------------------------------- reduce
    def summary(self, top: int = 10) -> dict:
        """The trace reduced to what the per-layer readers and the result's
        ``device`` and ``breakdown`` need; seconds throughout."""
        prof = self._prof
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
            "wall_s": self.wall_s, "busy_s": busy, "kernels": len(kernels),
            "kernel_s": by_name, "ranges_device_s": ranges,
            "device_ops": sorted(([n[:120], s] for n, s in by_name.items()),
                                 key=lambda t: -t[1])[:top],
            "idle_gaps": self._gaps(merged, host, top),
        }

    @staticmethod
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
