"""The port's own spans in the traced sub-window of a ``--trace 1`` run.

While torch.profiler runs, each span of `diskann_tpu_torch.trace` opens a
profiler range of its name for its length, and each of its ``sync`` waits
(a hop flag read, the answers' copy back) a range called ``sync``.  They
are function-scope ranges, with no event on the device's timeline, so
`annbench.tracing`'s summary counts the same kernels and busy time with
them as without.  This module reads their host side for the readers of
``metrics/``: how many ranges of a name the sub-window holds and their
summed host wall, from the profile that `annbench.tracing.Traced` keeps.
On a program that opens no such ranges every name reads (0, 0.0), and
the readers then return None.

These are readings of the profiler's trace, and BENCHMARK.json labels
them ``device_trace``: the port's own span records and counters over the
whole window (`diskann_tpu_torch.trace.spans` / ``counters``) are not
handed to the readers by this harness.  A host wall read here is taken
under the profiler, which adds its own cost to every op and launch (up to
about twice a one-query request's walk on an H100): compare it with other
traced readings and across commits, not with the window's host-clock
metrics.
"""

from __future__ import annotations

import weakref

import torch

_SEEN: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def host_ranges(run) -> dict:
    """{name: (count, host seconds)} of the traced sub-window's host-side
    events (ranges and ops); {} without a traced sub-window."""
    tracer = run.tracer
    prof = getattr(tracer, "_prof", None)
    if prof is None:
        return {}
    got = _SEEN.get(tracer)
    if got is None:
        dev = torch.autograd.DeviceType.CUDA
        got = {}
        for e in prof.events():
            if e.device_type != dev:
                c, s = got.get(e.name, (0, 0.0))
                got[e.name] = (c + 1, s + e.time_range.elapsed_us() / 1e6)
        _SEEN[tracer] = got
    return got


def count(run, name: str) -> int:
    return host_ranges(run).get(name, (0, 0.0))[0]


def seconds(run, name: str) -> float:
    return host_ranges(run).get(name, (0, 0.0))[1]


def rows_traced(run, op: str) -> float:
    """Rows the sub-window's ``op`` calls ("insert" or "delete") took: the
    benchmark's ``annbench.<op>`` ranges there, each as large as the
    window's mean call of that op (a mix's cycle repeats its sizes)."""
    sizes = [size for o, _, _, size in run.window["spans"] if o == op]
    calls = count(run, "annbench." + op)
    return calls * sum(sizes) / len(sizes) if sizes and calls else 0.0


def ms_per_krow(run, name: str, op: str):
    """Host ms of the ``name`` spans per 1,000 rows of the ``op`` calls."""
    rows = rows_traced(run, op)
    return seconds(run, name) * 1e3 / (rows / 1e3) if count(run, name) and rows else None
