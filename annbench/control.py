#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``, run by hand on
the card (the benchmark's own runs never run it):

    python3 annbench/control.py --workload <cell> --seeds <n> <n> <n> \\
        --seconds 3 [--precision tf32|bf16|float32] [--fault <name> ...]

Without ``--fault``: the exact search (`annbench.reference.flat.Exact`) put
in the port's place, computing in ``--precision`` (TF32, the precision
next below the configurations' float32; bf16, the product rounded to
bfloat16, for vectors on the uint8 grid, which TF32 holds exactly),
driven by the cell's own traffic at the cell's own size.  With
``--fault``: the port itself with each fault of `annbench.faults`
planted in turn (``none``: none, a sound reading).
Where the cell's mix only searches, a seed's faults all search one index,
built once (the faults patch the calls, not the index).  Prints, per seed
and fault, one JSON line: ``correct`` and every number compared, beside
its limit.
"""

import argparse
import contextlib
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the checkout, in place of annbench/ itself (whose file names would shadow
# top-level ones); a mesh worker, which runs this file again as its main
# module, starts with the path already set
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "annbench":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from annbench import manifest, system  # noqa: E402
from annbench.faults import FAULTS, planted  # noqa: E402
from annbench.reference.flat import Exact  # noqa: E402
from annbench.run import run_cell  # noqa: E402


class Reused:
    """The system of a seed's first run, handed to each later run of the
    seed; a run's close leaves it open, `shut` closes it."""

    def __init__(self):
        self.built = None

    def __call__(self, cfg, base, **labelled):
        if self.built is None:
            self.built = system.make(cfg, base, **labelled)
        return self

    def __getattr__(self, name):
        return getattr(self.built, name)

    def close(self):
        pass

    def shut(self):
        if self.built is not None:
            self.built.close()
            self.built = None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--precision", default="tf32")
    ap.add_argument("--fault", choices=("none",) + FAULTS, nargs="+")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    bench = manifest.Bench(ROOT)
    mix = bench.traffic(bench.cell(args.workload)["traffic"])
    searches_only = all(step["op"] == "search" for step in mix["cycle"])
    for seed in args.seeds:
        reused = Reused() if searches_only else None
        for fault in args.fault or [None]:
            kw = dict(seed=seed, seconds=args.seconds, trace=False, device="cuda:0",
                      t0=time.perf_counter())
            if fault is None:
                kw["make_system"] = functools.partial(Exact, precision=args.precision)
            elif reused is not None:
                kw["make_system"] = reused
            with planted(fault) if fault not in (None, "none") else contextlib.nullcontext():
                res, _ = run_cell(bench, args.workload, **kw)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": fault or args.precision,
                              "correct": res["correct"], "checks": res["checks"],
                              "metrics": res["metrics"]}), flush=True)
            torch.cuda.empty_cache()
        if reused is not None:
            reused.shut()
    return 0


if __name__ == "__main__":
    sys.exit(main())
