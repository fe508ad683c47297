#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``, run by hand on
the card (the benchmark's own runs never run it):

    python3 annbench/control.py --workload <cell> --seeds <n> <n> <n> \\
        --seconds 3 [--precision tf32|bf16|float32] [--fault <name>]

Without ``--fault``: the exact search (`annbench.reference.flat.Exact`) put
in the port's place, computing in ``--precision`` (TF32, the precision
next below the configurations' float32), driven by the cell's own traffic
at the cell's own size.  With ``--fault``: the port itself with a fault of
`annbench.faults` planted.  Prints, per seed, one JSON line: ``correct``
and every number compared, beside its limit.
"""

import argparse
import functools
import json
import sys
import time

from run import ROOT, run_cell  # sets sys.path to the checkout

import torch  # noqa: E402

from annbench import manifest  # noqa: E402
from annbench.faults import FAULTS, planted  # noqa: E402
from annbench.reference.flat import Exact  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--precision", default="tf32")
    ap.add_argument("--fault", choices=FAULTS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    bench = manifest.Bench(ROOT)
    for seed in args.seeds:
        kw = dict(seed=seed, seconds=args.seconds, trace=False, device="cuda:0",
                  t0=time.perf_counter())
        if args.fault:
            with planted(args.fault):
                res, _ = run_cell(bench, args.workload, **kw)
        else:
            res, _ = run_cell(bench, args.workload, **kw,
                              make_system=functools.partial(Exact, precision=args.precision))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.fault or args.precision,
                          "correct": res["correct"], "checks": res["checks"],
                          "metrics": res["metrics"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
