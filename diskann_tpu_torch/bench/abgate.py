"""Interleaved A/B gate — contention-decidable regression checking
(PyTorch port of `diskann_tpu/bench/abgate.py`).

The reference gates PRs with A/B disk benchmarks plus daily A/A noise-floor
jobs and an explicit 95%-reliability policy
(`.github/docs/disk-benchmarks-aa.md:7-60`).  A card shared with other
work, or one held below its power limit, moves identical runs, so:

- both sides run in ONE process, INTERLEAVED (A,B,A,B,...), so a contention
  window hits both sides instead of one;
- every timed rep is BRACKETED by a known-constant probe op; a rep whose
  probes exceed the clean threshold is discarded and RE-QUEUED (bounded);
- the verdict uses only probe-clean reps (median), via the same directional
  `check_tolerances` the JSON gate uses;
- if the chip never yields enough clean reps for a metric, the verdict is
  INDECISIVE (exit code 2) — an automated third state, never a hand edit.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Any, Callable

import numpy as np
import torch

from diskann_tpu_torch.bench.registry import check_tolerances
from diskann_tpu_torch.devices import default_device

# verdict -> process exit code (PASS 0 / FAIL 1 / INDECISIVE 2)
EXIT = {"PASS": 0, "FAIL": 1, "INDECISIVE": 2}


def make_probe(device=None) -> Callable[[], float]:
    """A known-constant device op timed end to end: eight chained bf16
    2048 x 2048 products, each through tanh, ending in a synchronize; the
    A/A noise floor sampled around every timed section.  A 2-3x rise over
    its clean time (`calibrate_clean_s`) means the card was shared or
    throttled during the bracketed rep.  Returns seconds, unrounded: the
    op takes about a millisecond on an H100."""
    device = default_device(device)
    a = torch.full((2048, 2048), 0.01, dtype=torch.bfloat16, device=device)

    def _op():
        s = a
        for _ in range(8):
            s = torch.tanh(s @ a)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return s

    _op()  # warm-up outside any timed window

    def probe() -> float:
        t0 = time.perf_counter()
        _op()
        return time.perf_counter() - t0

    return probe


def calibrate_clean_s(probe: Callable[[], float]) -> float:
    """The clean threshold from the probe's own time on this device: 3x its
    median over 9 calls.  The reference fixed 3.0 s for a ~1 s TPU probe,
    the same factor."""
    return 3.0 * statistics.median(probe() for _ in range(9))


@dataclasses.dataclass
class Side:
    """One arm of the A/B: index attributes + search call parameters."""

    name: str
    attrs: dict = dataclasses.field(default_factory=dict)      # idx attrs
    search: dict = dataclasses.field(default_factory=dict)     # search kwargs

    @staticmethod
    def parse(name: str, spec: str | dict) -> "Side":
        """Parse "l=40,mh=6,mtrunc=1,rcomp=bf16" (or a dict) into a Side.
        Recognized attr keys: unroll, rcomp, mtrunc; everything else is a
        search kwarg (l, mh, rl, rs, w, qdt).  The port has no unrolled hop
        loop: ``unroll`` sets an ``unroll_hops`` attribute that nothing
        reads, so a spec written for the reference still parses."""
        if isinstance(spec, str):
            kv = dict(
                item.split("=", 1) for item in spec.split(",") if item
            )
        else:
            kv = dict(spec)
        attrs, search = {}, {}
        for key, v in kv.items():
            if key == "unroll":
                attrs["unroll_hops"] = str(v) in ("1", "true", "True")
            elif key == "rcomp":
                attrs["router_compute"] = str(v)
            elif key == "mtrunc":
                attrs["merge_trunc"] = str(v) in ("1", "true", "True")
            elif key == "qdt":
                # NOTE: np.dtype("i8") is int64 (numpy byte-count codes) —
                # the int8 wire must stay the literal "i8" sentinel, which
                # GraphIndex.search resolves to the i8pack encoder
                sv = str(v)
                search["query_dtype"] = (
                    None if sv in ("f32", "float32", "")
                    else "i8" if sv in ("i8", "int8", "i8pack")
                    else np.dtype(sv)
                )
            else:
                dest = {"l": "l_search", "mh": "max_hops", "rl": "rerank_l",
                        "rs": "router_starts", "w": "beam_width"}.get(key, key)
                search[dest] = int(v)
        return Side(name=name, attrs=attrs, search=search)


def _apply(idx, side: Side):
    for key, v in side.attrs.items():
        setattr(idx, key, v)


def interleaved_search_gate(
    idx,
    queries: np.ndarray,
    gt: np.ndarray,
    k: int,
    side_a: Side,
    side_b: Side,
    *,
    mode: str = "packed",
    reps: int = 3,
    max_attempts: int = 8,
    clean_s: float = 3.0,
    probe: Callable[[], float] | None = None,
    log: Callable[[str], None] = lambda s: None,
) -> dict:
    """Run both sides interleaved on ONE index; return per-side results.

    Each attempt runs one timed rep of A then one of B, each bracketed by
    probes.  Attempts continue until both sides hold `reps` probe-clean reps
    or `max_attempts` is exhausted.  recall is measured once per side
    (deterministic — contention cannot change it)."""
    from diskann_tpu_torch.bench.recall import knn_recall

    probe = probe or make_probe()
    nq = queries.shape[0]
    out: dict[str, dict] = {}
    for side in (side_a, side_b):
        _apply(idx, side)
        _, ids, _ = idx.search(queries, k, mode=mode, **side.search)  # compile
        out[side.name] = {
            "recall": round(float(knn_recall(ids, gt, k)), 6),
            "reps": [],
            "config": {"attrs": side.attrs,
                       "search": {sk: str(sv) for sk, sv in side.search.items()}},
        }

    def clean_qps(entry) -> list[float]:
        return [r["qps"] for r in entry["reps"] if r["clean"]]

    for attempt in range(max_attempts):
        done = all(
            len(clean_qps(out[s.name])) >= reps for s in (side_a, side_b)
        )
        if done:
            break
        for side in (side_a, side_b):
            entry = out[side.name]
            if len(clean_qps(entry)) >= reps:
                continue
            _apply(idx, side)
            p0 = probe()
            t0 = time.time()
            idx.search(queries, k, mode=mode, **side.search)
            dt = time.time() - t0
            p1 = probe()
            rep = {"qps": round(nq / dt, 1), "probe_before": p0,
                   "probe_after": p1, "clean": max(p0, p1) <= clean_s}
            entry["reps"].append(rep)
            log(f"[abgate] {side.name} attempt {attempt}: qps={rep['qps']} "
                f"probes=({p0},{p1}) {'CLEAN' if rep['clean'] else 'DIRTY'}")

    for name, entry in out.items():
        cq = clean_qps(entry)
        entry["clean_reps"] = len(cq)
        entry["qps"] = round(statistics.median(cq), 1) if cq else None
    return out


def interleaved_build_gate(
    x,
    config,
    build_kw_a: dict,
    build_kw_b: dict,
    *,
    rounds: int = 2,
    clean_s: float = 3.0,
    probe: Callable[[], float] | None = None,
    log: Callable[[str], None] = lambda s: None,
) -> dict:
    """Interleaved build-rate A/B (A,B,A,B): each build is bracketed by
    probes; the verdict value per side is the BEST probe-clean rate (build
    rate is a capability number — the max the chip allows — so best-of is
    the right statistic under one-sided noise; reference A/A policy retries
    noisy runs the same way)."""
    from diskann_tpu_torch.graph.index import GraphIndex

    probe = probe or make_probe()
    n = int(x.shape[0])
    out = {"A": {"reps": []}, "B": {"reps": []}}
    for _ in range(rounds):
        for name, kw in (("A", build_kw_a), ("B", build_kw_b)):
            p0 = probe()
            t0 = time.time()
            idx = GraphIndex.build(x, config, **kw)
            if idx.device.type == "cuda":
                torch.cuda.synchronize(idx.device)
            dt = time.time() - t0
            p1 = probe()
            del idx
            rep = {"points_per_s": round(n / dt, 1), "build_s": round(dt, 1),
                   "probe_before": p0, "probe_after": p1,
                   "clean": max(p0, p1) <= clean_s}
            out[name]["reps"].append(rep)
            log(f"[abgate] build {name}: {rep['points_per_s']} pts/s "
                f"probes=({p0},{p1}) {'CLEAN' if rep['clean'] else 'DIRTY'}")
    for entry in out.values():
        clean = [r["points_per_s"] for r in entry["reps"] if r["clean"]]
        entry["clean_reps"] = len(clean)
        entry["points_per_s"] = max(clean) if clean else None
    return out


def decide(
    search_res: dict | None,
    build_res: dict | None,
    tolerances: dict | None = None,
) -> tuple[str, list[str]]:
    """PASS / FAIL / INDECISIVE from interleaved results.  A metric with no
    probe-clean reps on either side is INDECISIVE (it cannot fail); any
    decidable metric beyond tolerance fails the gate."""
    tolerances = tolerances or {
        "qps": {"tol": 0.10, "direction": "higher_is_better"},
        "recall": {"tol": 0.01, "direction": "higher_is_better"},
        "points_per_s": {"tol": 0.10, "direction": "higher_is_better"},
    }
    lines: list[str] = []
    a_vals: dict[str, Any] = {}
    b_vals: dict[str, Any] = {}
    indecisive: list[str] = []

    if search_res is not None:
        names = list(search_res)
        sa, sb = search_res[names[0]], search_res[names[1]]
        a_vals["recall"], b_vals["recall"] = sa["recall"], sb["recall"]
        if sa["qps"] is not None and sb["qps"] is not None:
            a_vals["qps"], b_vals["qps"] = sa["qps"], sb["qps"]
        else:
            indecisive.append("qps: no probe-clean reps on one side")
    if build_res is not None:
        ba, bb = build_res["A"], build_res["B"]
        if ba["points_per_s"] is not None and bb["points_per_s"] is not None:
            a_vals["points_per_s"] = ba["points_per_s"]
            b_vals["points_per_s"] = bb["points_per_s"]
        else:
            indecisive.append("points_per_s: no probe-clean reps on one side")

    tol = {m: spec for m, spec in tolerances.items() if m in a_vals}
    pf = check_tolerances(a_vals, b_vals, tol)
    for metric in tol:
        va, vb = a_vals[metric], b_vals[metric]
        chg = (float(vb) - float(va)) / max(abs(float(va)), 1e-30)
        lines.append(f"  {metric}: {va} -> {vb} ({chg:+.1%})")
    for msg in indecisive:
        lines.append(f"  INDECISIVE {msg}")

    if not pf.passed:
        verdict = "FAIL"
        lines.append("FAIL:")
        lines.extend(f"  {m}" for m in pf.failures)
    elif indecisive:
        verdict = "INDECISIVE"
        lines.append(
            "INDECISIVE: chip contention never cleared for some metrics; "
            "re-run the gate (no decidable metric regressed)"
        )
    else:
        verdict = "PASS"
        lines.append(f"PASS ({pf.checks} checks, interleaved probe-clean)")
    return verdict, lines


def render_artifact(
    header: str, search_res, build_res, verdict: str, lines: list[str]
) -> str:
    body = [header, ""]
    body.extend(lines)
    body.append("")
    body.append("# raw interleaved reps (machine-readable)")
    body.append(json.dumps(
        {"search": search_res, "build": build_res, "verdict": verdict}
    ))
    return "\n".join(body) + "\n"
