#!/usr/bin/env python3
"""One run of one cell of the port's benchmark, on the CUDA card(s) of this
machine:

    python3 annbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

1. makes the cell's data and query pool from ``--seed`` on the card
   (`annbench.reference.synth`), for a configuration with a ``labels``
   block with the rows' tags and a predicate a query;
2. builds the system under test (`annbench.system.make`: `Port`, the
   port's normal entry, ``GraphIndex.build``, then ``attach_packed`` where
   the configuration re-attaches; for a configuration with a ``shards``
   block, `Sharded`: a ``ShardedGraphIndex`` on a mesh of one worker
   process a card; for one with a ``labels`` block, `Filtered`: `Port`'s
   index with the tags attached, searched with a predicate a query); the
   first run in a checkout builds the port's kernel library into its own
   ``_build/`` there;
3. runs the mix's warm-up cycles; set-up (``setup_s``) ends here, at the
   first timed call, and is counted from this process's start;
4. drives the mix for ``--seconds`` (`annbench.driver`), timing the
   system's ``HOST_SPANS`` on the host clock; with ``--trace 1`` then a
   traced sub-window (`annbench.tracing`), in every mesh worker too;
5. reads the peak memory (the fullest card's: on the caller's own card
   its peak and its mesh worker's summed), probes the acknowledged
   inserts, frees the index (and ends the mesh's workers), and judges
   every answer against the exact answers worked out again from the seed
   (`annbench.reference.check`);
6. prints each number compared beside its limit as the last lines of
   standard error, and one JSON line as the last line of standard output:
   ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
   end-to-end metrics, or with ``--trace 1`` its per-layer ones),
   ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.

It exits non-zero and prints no result when the card is missing or too
few, when the port cannot be imported, and when JAX, jaxlib, flax or the
JAX package ``diskann_tpu`` is loaded once the window has closed, in this
process or in any mesh worker.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the checkout, for the benchmark's package and the port; run as a script,
# in place of annbench/ itself, whose file names would shadow top-level ones
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from annbench import manifest  # noqa: E402
from annbench.driver import Driver  # noqa: E402
from annbench.reference import check  # noqa: E402
from annbench.reference.exact import percentile  # noqa: E402
from annbench.reference.synth import Clustered, Tagged  # noqa: E402
from annbench.roofline import PEAKS  # noqa: E402
from annbench.system import make  # noqa: E402
from annbench.tracing import (HostSpans, Traced, forbidden_modules,  # noqa: E402
                              worker_peak_bytes)

PROBES = 1024


class Forbidden(RuntimeError):
    """A mesh worker of the run loaded JAX or the JAX package
    (`annbench.tracing.FORBIDDEN`)."""


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def probe(driver, lo: int, hi: int, seed: int) -> list[dict]:
    """Search for a seeded sample of the live rows [lo, hi), each by its
    own vector, through the configured search."""
    if hi <= lo:
        return []
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(np.arange(lo, hi), size=min(PROBES, hi - lo), replace=False))
    vecs = driver.data.rows(lo, hi)[torch.as_tensor(rows - lo, device=driver.data.device)]
    _, slots, _ = driver.system.search(vecs.cpu().numpy())
    return [{"expect": rows, "rows": driver._rows_of(slots)}]


def misses(probes: list[dict]) -> str:
    return "/".join(str(v) for v in (
        sum(int((~(p["rows"] == p["expect"][:, None]).any(1)).sum()) for p in probes),
        sum(len(p["expect"]) for p in probes)))


def read_metrics(bench: manifest.Bench, cell: str, kind: str, run) -> dict:
    """The cell's ``kind`` metrics, each by its reader; one that finds
    nothing to read is left out."""
    out = {}
    for m in bench.metrics(cell, kind):
        v = manifest.reader(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(bench: manifest.Bench, name: str, *, seed: int, seconds: float, trace: bool,
             device, t0: float, make_system=None, overrides: dict | None = None):
    """One run of cell ``name``.  Returns (the result line's dict, the
    rows of numbers beside their limits).  ``make_system(cfg, base)``
    replaces the port (the control); ``overrides`` lays {"config": ...,
    "traffic": ...} over the cell's files (the tests' small sizes)."""
    cell = bench.cell(name)
    over = overrides or {}
    cfg = manifest.merge(bench.config(cell["config"]), over.get("config", {}))
    mix = manifest.merge(bench.traffic(cell["traffic"]), over.get("traffic", {}))
    device = torch.device(device)
    cuda = device.type == "cuda"

    times = {}
    t = time.perf_counter()
    data = Clustered(seed, cfg["data"], device)
    n = int(cfg["data"]["n"])
    pool_dev = data.queries(int(mix["query_pool"]))
    pool = pool_dev.cpu().numpy()
    base = data.rows(0, n)
    tags = preds = None
    labelled = {}
    if "labels" in cfg:
        tags = Tagged(seed, cfg, data)
        preds = tags.predicates(pool.shape[0], n)
        labelled["labels"] = tags.rows(0, n)
    times["data_s"] = time.perf_counter() - t
    t = time.perf_counter()
    system = (make_system or make)(cfg, base, **labelled)
    del base, labelled
    if cuda:
        torch.cuda.synchronize(device)
    times["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    driver = Driver(mix, system, data, pool, n, seed,
                    preds=None if preds is None else preds.cpu().numpy())
    driver.warm()
    if cuda:
        torch.cuda.synchronize(device)
    times["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0

    segments = (lambda: torch.cuda.memory_stats(device).get("segment.all.allocated", 0)
                if cuda else 0)
    seg0 = segments()
    on_cards = getattr(system, "on_cards", None)
    tracer = Traced(device, on_cards) if trace else None
    host = HostSpans(getattr(system, "HOST_SPANS", ()))
    try:
        with host:
            rec = driver.run(seconds, traced=float(mix["trace_seconds"]) if trace else 0.0,
                             on_trace=lambda: tracer)
    except Exception:
        traceback.print_exc()
        rec = {"window_s": 0.0, "spans": driver.spans, "latencies": driver.latencies,
               "service": driver.service, "late": driver.late, "hops": driver.hops,
               "queries": driver.queries, "attempted": driver.attempted,
               "failed": max(driver.failed, 1)}
    times["window_s"] = rec["window_s"]
    # allocations the caching allocator had to ask the driver for after set-up
    new_segments = segments() - seg0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    card_peaks = on_cards(worker_peak_bytes) if on_cards and cuda else {}
    loaded = {c: m for c, m in on_cards(forbidden_modules).items() if m} if on_cards else {}
    if card_peaks:
        own = f"cuda:{device.index or 0}"
        peak = max(b + (peak if c == own else 0) for c, b in card_peaks.items())
    t = time.perf_counter()
    probes, built = [], []
    if rec["failed"] == 0:
        # the acknowledged inserts (compared), and the rows of the build
        # still live (a diagnostic beside them)
        probes = probe(driver, max(driver.live[0], n), driver.live[1], seed)
        built = probe(driver, driver.live[0], min(n, driver.live[1]), seed) if probes else []
    times["probes_s"] = time.perf_counter() - t
    t = time.perf_counter()
    summary = tracer.summary() if trace else None
    times["trace_summary_s"] = time.perf_counter() - t

    # what a reader sees; ``numbers`` (the comparison's) joins it below
    run = SimpleNamespace(window=rec, setup_s=setup_s, tracer=tracer, trace=summary,
                          host_spans=host,
                          peak=PEAKS.get(torch.cuda.get_device_name(device)) if cuda else None)
    if trace:
        metrics = read_metrics(bench, name, "per_layer", run)
        tracer.k1_calls.clear()
        tracer.k2_calls.clear()

    rows_per_shard = getattr(system, "rows_per_shard", None)
    system.close()
    driver.system = system = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if loaded:
        raise Forbidden(f"mesh workers loaded after the window: {loaded}")
    t = time.perf_counter()
    run.numbers = check.measure(driver.answers, probes, data, pool_dev, k=cfg["k"],
                                query_dtype=manifest.serve_kw(cfg).get("query_dtype"),
                                failed=rec["failed"], labels=tags, preds=preds)
    correct, rows = check.judge(run.numbers, cfg["limits"])
    times["reference_s"] = time.perf_counter() - t
    lat = [x * 1e3 for x in rec["latencies"]]
    print(f"annbench: {name} seed {seed}: " + json.dumps({
        **times, "setup_s": setup_s, "cycles": len(rec["spans"]),
        "new_segments": new_segments, "card_peaks": card_peaks,
        "rows_per_shard": rows_per_shard,
        "self_search_misses": {"inserted": misses(probes), "built": misses(built)},
        "latency_ms": {p: percentile(lat, p) for p in (50, 95, 99)} if lat else None,
        "late_ms_max": max(rec["late"]) * 1e3 if rec["late"] else None,
        "service_ms": {p: percentile(rec["service"], p) * 1e3 for p in (5, 50, 95, 99, 100)}
        if rec["service"] else None,
        **({"recall_by_band": run.numbers["recall_by_band"]}
           if "recall_by_band" in run.numbers else {})}), file=sys.stderr)

    if not trace:
        metrics = read_metrics(bench, name, "end_to_end", run)
    result = {"correct": bool(correct), "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": int(cell["chips"]), "memory_peak_bytes": int(peak),
                         "power_limit_w": power_limit_w() if cuda else None}}
    if trace:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["wall_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        if tracer.missing:
            print(f"annbench: the port no longer has {tracer.missing}", file=sys.stderr)
    result["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]} for r in rows}
    return result, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = manifest.Bench(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"annbench: {args.workload} needs {cell['chips']} CUDA device(s); this "
              f"machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result, rows = run_cell(bench, args.workload, seed=args.seed, seconds=args.seconds,
                                trace=bool(args.trace), device="cuda:0", t0=T0)
    except Forbidden as e:
        print(f"annbench: {e}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"annbench: loaded after the window: {found}", file=sys.stderr)
        return 3
    for r in rows:
        rel = "<=" if r["rel"] == "max" else ">="
        print(f"check {r['name']} {r['value']} {rel} {r['limit']} "
              f"{'ok' if r['ok'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
