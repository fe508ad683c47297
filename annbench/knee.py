#!/usr/bin/env python3
"""The rate sweep that fixes an open-loop cell's arrival rate, run once by
hand on the card:

    python3 annbench/knee.py --workload sift1m.search-online --seed <n> \\
        --seconds 10 --rates 12 20 29.5 40

Builds the cell's index as a run does, times the mix's cycle back to back
for ``--seconds`` (the most it can serve: ``closed_rate``, and the p95 of
a request served alone), then offers Poisson arrivals at each rate (per
second) for ``--seconds`` each and prints, per rate, the latency
percentiles, how late requests started, and the backlog at the end (the
last request's wait).  The rate sustained is the highest whose p95 stays
within twice that of a request served alone; the cell's file takes 0.8 of
it.
"""

import argparse
import json
import sys
import time

from run import ROOT  # sets sys.path to the checkout

import numpy as np  # noqa: E402
import torch  # noqa: E402

from annbench import manifest  # noqa: E402
from annbench.driver import Driver, schedule  # noqa: E402
from annbench.reference.exact import percentile  # noqa: E402
from annbench.reference.synth import Clustered  # noqa: E402
from annbench.system import Port  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("knee: needs a CUDA card", file=sys.stderr)
        return 2
    bench = manifest.Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    data = Clustered(args.seed, cfg["data"], "cuda:0")
    pool = data.queries(int(mix["query_pool"])).cpu().numpy()
    n = int(cfg["data"]["n"])
    driver = Driver(mix, Port(cfg, data.rows(0, n)), data, pool, n, args.seed)
    driver.warm()
    window = driver.closed(args.seconds)
    rate = driver.attempted / window
    svc = [(e - s) * 1e3 for _, s, e, _ in driver.spans]
    print(json.dumps({"closed_rate": rate, "calls": len(svc),
                      **{f"service_ms_p{p}": percentile(svc, p) for p in (5, 50, 95, 99)}}),
          flush=True)
    for r in args.rates:
        driver.reset()
        due = schedule({"kind": "poisson", "rate_per_s": r}, args.seconds)
        driver.open(due, time.perf_counter())
        lat = np.array(driver.latencies) * 1e3
        print(json.dumps({"rate_per_s": r, "requests": len(lat),
                          "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
                          "p99_ms": percentile(lat, 99),
                          "late_ms_mean": float(np.mean(driver.late)) * 1e3,
                          "service_ms_p50": percentile(driver.service, 50) * 1e3,
                          "service_ms_p95": percentile(driver.service, 95) * 1e3,
                          "last_wait_ms": float(driver.late[-1]) * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
