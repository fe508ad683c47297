"""The one traffic generator: it reads a mix's data file
(`annbench/traffic/<mix>.json`) and drives the system under test with it.

A mix is a ``cycle`` of steps, each one call of the system:

- ``{"op": "search", "queries": B}``: the next B queries of the pool;
- ``{"op": "insert", "rows": R}``: the next R rows of the seeded stream;
- ``{"op": "delete", "rows": R}``: the R oldest live rows.

``"loop": "closed"`` runs cycles back to back, one client; the window ends
when the cycle in flight at ``--seconds`` has finished, so a rate is taken
over whole cycles.  ``"loop": "open"`` runs one cycle per arrival, served
one at a time in arrival order, each timed from the moment it was due;
``arrivals`` is ``{"kind": "poisson", "rate_per_s": r}``.  Every seed
gets the same arrival times.
``query_pool`` is the number of seeded queries cycled through, from a
seeded place, ``warmup_cycles`` the cycles run in set-up, and
``trace_seconds`` the length of the traced sub-window of a ``--trace 1``
run, which continues the traffic after the window.

For a label-filtered system the pool's queries come with one predicate
each (``preds``), and a search step hands the system its queries'
predicates with their vectors.
"""

from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function

OPS = ("search", "insert", "delete")
LOOPS = ("closed", "open")


def validate(mix: dict) -> None:
    """Raise unless ``mix`` is a mix this generator can run."""
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"loop must be one of {LOOPS}")
    for step in mix["cycle"]:
        if step.get("op") not in OPS:
            raise ValueError(f"unknown op in {step}")
        size = step.get("queries" if step["op"] == "search" else "rows")
        if not isinstance(size, int) or size < 1:
            raise ValueError(f"step {step} needs a positive size")
    if mix["loop"] == "open":
        a = mix["arrivals"]
        if a.get("kind") != "poisson" or not a.get("rate_per_s", 0) > 0:
            raise ValueError(f"bad arrivals {a}")
    for key in ("query_pool", "warmup_cycles", "trace_seconds"):
        if key not in mix:
            raise ValueError(f"mix lacks {key!r}")


def schedule(arrivals: dict, horizon_s: float) -> np.ndarray:
    """Due times (s from the window's start) of the open loop's arrivals
    up to ``horizon_s``: one fixed draw of exponential gaps, the same for
    every seed (a queue's tail follows the order of its gaps, so a seed
    that reordered them would change the work; the seed orders the
    queries instead)."""
    rate = float(arrivals["rate_per_s"])
    n = int(rate * horizon_s * 1.25) + 64
    gaps = np.random.default_rng(0).exponential(1.0 / rate, n)
    t = np.cumsum(gaps) - gaps[0]
    return t[t < horizon_s]


class Driver:
    """Runs a mix against ``system``, keeps the map between the stream's
    rows and the system's slots (a sharded index's external ids, which
    are the rows themselves), and records what the window did: each
    search's answer (for the reference), each call's span, the counters
    and, in the open loop, each request's latency."""

    def __init__(self, mix: dict, system, data, pool: np.ndarray, n_base: int,
                 seed: int, preds: np.ndarray | None = None):
        validate(mix)
        self.mix = mix
        self.system = system
        self.data = data
        self.pool = pool
        self.preds = preds
        self.seed = seed
        self.live = [0, n_base]            # rows [lo, hi) are live
        self.row_slot = np.arange(n_base, dtype=np.int64)
        self.slot_row = np.arange(n_base, dtype=np.int64)
        # a seeded place in the pool, on a call boundary of the first step
        b = next((st["queries"] for st in mix["cycle"] if st["op"] == "search"), 1)
        self.cursor = int(np.random.default_rng(seed).integers(pool.shape[0] // b)) * b
        self.ranges = False                # record_function ranges (traced)
        self.reset()

    def reset(self) -> None:
        self.answers: list[dict] = []
        self.spans: list[tuple] = []       # (op, start, end, items)
        self.latencies: list[float] = []   # open loop: due -> done, s
        self.service: list[float] = []     # open loop: start -> done, s
        self.late: list[float] = []        # open loop: due -> start, s
        self.hops = 0
        self.queries = 0
        self.attempted = 0
        self.failed = 0

    # ------------------------------------------------------------- the calls
    def _rows_of(self, slots: np.ndarray) -> np.ndarray:
        s = np.asarray(slots, np.int64)
        ok = (s >= 0) & (s < self.slot_row.shape[0])
        return np.where(ok, self.slot_row[np.where(ok, s, 0)], -1)

    def _search(self, b: int) -> None:
        c, n = self.cursor, self.pool.shape[0]
        qi = (c + np.arange(b)) % n
        self.cursor = int(qi[-1] + 1) % n
        # a slice of the pool where it does not wrap: no copy in the window
        q = self.pool[c:c + b] if c + b <= n else self.pool[qi]
        if self.preds is None:
            d, slots, hops = self.system.search(q)
        else:
            d, slots, hops = self.system.search(
                q, self.preds[c:c + b] if c + b <= n else self.preds[qi])
        self.answers.append({"q": qi, "rows": self._rows_of(slots), "dists": d,
                             "live": tuple(self.live)})
        if hops is not None:       # a sharded search counts no hops
            self.hops += int(np.asarray(hops).sum())
        self.queries += b

    def _insert(self, r: int) -> None:
        lo = self.live[1]
        vectors = self.data.rows(lo, lo + r)
        slots = self.system.insert(vectors)
        if self.row_slot.shape[0] < lo + r:
            self.row_slot = np.concatenate(
                [self.row_slot, np.full(lo + r - self.row_slot.shape[0], -1, np.int64)])
        self.row_slot[lo:lo + r] = slots
        top = int(slots.max()) + 1
        if self.slot_row.shape[0] < top:
            self.slot_row = np.concatenate(
                [self.slot_row, np.full(top - self.slot_row.shape[0], -1, np.int64)])
        self.slot_row[slots] = np.arange(lo, lo + r)
        self.live[1] = lo + r

    def _delete(self, r: int) -> None:
        lo = self.live[0]
        r = min(r, self.live[1] - lo)
        slots = self.row_slot[lo:lo + r]
        self.system.delete(slots)
        self.slot_row[slots] = -1
        self.live[0] = lo + r

    def step(self, step: dict) -> None:
        op = step["op"]
        size = step["queries"] if op == "search" else step["rows"]
        fn = {"search": self._search, "insert": self._insert, "delete": self._delete}[op]
        self.attempted += 1
        t0 = time.perf_counter()
        try:
            if self.ranges:
                with record_function(f"annbench.{op}"):
                    fn(size)
            else:
                fn(size)
        except Exception:
            self.failed += 1
            raise
        self.spans.append((op, t0, time.perf_counter(), size))

    def cycle(self) -> None:
        for step in self.mix["cycle"]:
            self.step(step)

    # ------------------------------------------------------------- the loops
    def warm(self) -> None:
        """The mix's warm-up cycles, part of set-up: their records are
        dropped, the rows they inserted and deleted stay so."""
        for _ in range(int(self.mix["warmup_cycles"])):
            self.cycle()
        self.reset()

    def closed(self, seconds: float) -> float:
        """Whole cycles until ``seconds`` have passed; returns the window's
        length in seconds."""
        t0 = time.perf_counter()
        while True:
            self.cycle()
            if time.perf_counter() - t0 >= seconds:
                return time.perf_counter() - t0

    def open(self, due: np.ndarray, origin: float) -> float:
        """One cycle per due time (s after ``origin``, a perf_counter
        reading), in order, each waited for if early; returns the seconds
        from the first due time to the last cycle's end."""
        for t in due:
            at = origin + float(t)
            now = time.perf_counter()
            if now < at - 0.002:
                time.sleep(at - now - 0.002)
            while time.perf_counter() < at:
                pass
            start = time.perf_counter()
            self.cycle()
            end = time.perf_counter()
            self.latencies.append(end - at)
            self.service.append(end - start)
            self.late.append(start - at)
        return time.perf_counter() - (origin + float(due[0]))

    def run(self, seconds: float, *, traced: float = 0.0, on_trace=None) -> dict:
        """The measured window and, with ``traced`` > 0, the traced
        sub-window after it, inside ``on_trace`` (a context manager
        factory).  Returns the window's records; the sub-window's answers
        join the window's for the reference."""
        out: dict = {}
        if self.mix["loop"] == "closed":
            out["window_s"] = self.closed(seconds)
        else:
            due = schedule(self.mix["arrivals"], seconds + traced)
            origin = time.perf_counter()
            win = due[due < seconds]
            out["window_s"] = self.open(win, origin)
        out.update(spans=self.spans, latencies=self.latencies, service=self.service,
                   late=self.late, hops=self.hops, queries=self.queries,
                   attempted=self.attempted, failed=self.failed)
        if traced > 0:
            answers = self.answers
            self.reset()
            self.answers = answers
            self.ranges = True
            with on_trace() as tr:
                if self.mix["loop"] == "closed":
                    self.closed(traced)
                else:
                    # the schedule goes on from the profiler's start
                    rest = due[due >= seconds]
                    if rest.size == 0:
                        rest = due[-1:]
                    self.open(rest, time.perf_counter() - float(rest[0]))
                tr.queries = self.queries
            self.ranges = False
            out["attempted"] += self.attempted
            out["failed"] += self.failed
        return out
