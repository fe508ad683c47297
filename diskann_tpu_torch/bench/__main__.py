"""Benchmark CLI (PyTorch port of `python -m diskann_tpu.bench`, which
replaces the `diskann-benchmark` binary).

    python -m diskann_tpu_torch.bench run jobs.json [-o results.json] [--device cpu]
    python -m diskann_tpu_torch.bench list
    python -m diskann_tpu_torch.bench check A.json B.json tolerances.json
    python -m diskann_tpu_torch.bench abgate --a "l=24,mtrunc=0" --b "l=24,mtrunc=1"

Jobs are JSON: [{"benchmark": "graph-index", ...}, ...] — see
`diskann_tpu_torch/bench/example/` (the reference's job files, unchanged).
The jobs and the gate run on the CUDA card unless ``--device`` (or a
job's own ``"device"`` key) says otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="diskann_tpu_torch.bench")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run")
    r.add_argument("jobs")
    r.add_argument("-o", "--out")
    r.add_argument("--trace", help="export host-side spans and counters as JSON "
                   "(json_spancollector analogue)")
    r.add_argument("--device", help="device of the jobs that name none "
                   "(default: the CUDA card)")

    sub.add_parser("list")

    c = sub.add_parser("check")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("tolerances")

    g = sub.add_parser(
        "abgate",
        help="contention-proof interleaved A/B gate (A,B,A,B reps, probe "
        "brackets, auto-requeue; PASS/FAIL/INDECISIVE with no manual "
        "disposition channel)",
    )
    g.add_argument("--n", type=int, default=1_000_000)
    g.add_argument("--nq", type=int, default=8192)
    g.add_argument("--k", type=int, default=10)
    g.add_argument("--a", required=True,
                   help='side A, e.g. "l=40,mh=6,rl=12,mtrunc=0"')
    g.add_argument("--b", required=True, help="side B (same syntax)")
    g.add_argument("--reps", type=int, default=3)
    g.add_argument("--clean-s", type=float, default=None,
                   help="probe seconds above which a rep is dirty (default: "
                   "3x the probe's median on this device)")
    g.add_argument("--max-attempts", type=int, default=8)
    g.add_argument("--build-n", type=int, default=0,
                   help="also interleave 2x2 builds at this N (0 = skip)")
    g.add_argument("--attach-dp", type=int, default=128)
    g.add_argument("--idx-cache", default="",
                   help="load the shared index from this GraphIndex.save "
                   "dir instead of building fresh (the headline bench's "
                   "BENCH_SAVE_IDX cache); search-config gates only need "
                   "ONE index, whoever built it (either package's record)")
    g.add_argument("--device", help="default: the CUDA card")
    g.add_argument("-o", "--out", help="artifact file to write")

    args = ap.parse_args(argv)

    from diskann_tpu_torch.bench.harness import default_registry

    reg = default_registry()

    if args.cmd == "list":
        for name in reg.names():
            print(name)
    elif args.cmd == "run":
        if args.trace:
            from diskann_tpu_torch import trace

            trace.enable(True)
        with open(args.jobs) as f:
            spec = json.load(f)
        jobs = spec if isinstance(spec, list) else spec["jobs"]
        if args.device:
            jobs = [{"device": args.device} | j for j in jobs]
        results = reg.run_jobs(jobs)
        text = json.dumps(results, indent=2)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        print(text)
        if args.trace:
            n = trace.export_spans(args.trace)
            print(f"wrote {n} spans to {args.trace}", file=sys.stderr)
    elif args.cmd == "check":
        from diskann_tpu_torch.bench.registry import check_tolerances

        def load_result(path):
            with open(path) as f:
                d = json.load(f)
            # a result wrapped as {"cmd": ..., "rc": ..., "parsed": {...}}
            # is unwrapped, so one tolerance file gates both raw and
            # wrapped artifacts
            if isinstance(d, dict) and isinstance(d.get("parsed"), dict):
                return d["parsed"]
            return d

        a = load_result(args.a)
        b = load_result(args.b)
        with open(args.tolerances) as f:
            tol = json.load(f)
        pf = check_tolerances(a, b, tol)
        # self-describing gate output: show each compared metric's values
        # (the committed AB_GATE_* files should be readable on their own)
        def dig(d, dotted):
            cur = d
            for part in dotted.split("."):
                if not isinstance(cur, dict) or part not in cur:
                    return None
                cur = cur[part]
            return cur

        for metric, spec in tol.items():
            va, vb = dig(a, metric), dig(b, metric)
            if va is None or vb is None:
                print(f"  {metric}: missing ({va} -> {vb})")
                continue
            chg = (float(vb) - float(va)) / max(abs(float(va)), 1e-30)
            print(f"  {metric}: {va} -> {vb} ({chg:+.1%})")
        if pf.passed:
            print(f"PASS ({pf.checks} checks)")
        else:
            print("FAIL:")
            for msg in pf.failures:
                print(" ", msg)
            sys.exit(1)
    elif args.cmd == "abgate":
        sys.exit(_abgate(args))


def _abgate(args) -> int:
    """Self-contained interleaved A/B gate over the headline workload:
    build ONE index (the sides share it — search-config gates), then run
    probe-bracketed interleaved search reps and optionally 2x2 interleaved
    builds.  Writes a self-describing artifact with an automated
    PASS/FAIL/INDECISIVE verdict (reference A/B CI + A/A noise policy,
    `.github/docs/disk-benchmarks-aa.md:7-60`)."""
    import os
    import time

    import numpy as np

    from diskann_tpu_torch import FlatIndex, GraphConfig, GraphIndex, Metric
    from diskann_tpu_torch.bench.abgate import (
        EXIT, Side, calibrate_clean_s, decide, interleaved_build_gate,
        interleaved_search_gate, make_probe, render_artifact,
    )
    from diskann_tpu_torch.bench.harness import make_clustered
    from diskann_tpu_torch.devices import default_device

    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    n, nq, k = args.n, args.nq, args.k
    d = 128
    device = default_device(args.device)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cache = os.path.join(repo, ".cache")
    os.makedirs(cache, exist_ok=True)

    # numpy data (the reference made it with JAX's generator on the chip,
    # so its cached truth is for other points: the file names differ)
    x, q = make_clustered(0, n, nq, d, n_clusters=4096, sigma=0.35)
    gt_cache = f"{cache}/gt_np_s0_c4096_sig0.35_{n}_{nq}_{d}_{k}.npy"
    if os.path.exists(gt_cache):
        gt = np.load(gt_cache)
    else:
        log("[abgate] computing exact groundtruth")
        _, gt = FlatIndex(x, Metric.L2, device=device).search(q, k=k)
        np.save(gt_cache, gt)
    qn = q

    cfg = GraphConfig(max_degree=64, l_build=100, alpha=1.2, beam_width=4,
                      build_max_hops=12, max_occlusion_size=256)
    build_kw = dict(insert_batch_size=8192, search_batch_size=2048,
                    build_mode="packed", packed_dp=64, device=device)
    t0 = time.time()
    if args.idx_cache and os.path.isdir(args.idx_cache):
        idx = GraphIndex.load(args.idx_cache, device=device, search_batch_size=2048)
        log(f"[abgate] shared index loaded in {time.time()-t0:.1f}s")
    else:
        idx = GraphIndex.build(x, cfg, **build_kw)
        log(f"[abgate] shared index built in {time.time()-t0:.1f}s")
    if args.attach_dp:
        idx.attach_packed(dp=args.attach_dp)

    probe = make_probe(device)
    if args.clean_s is None:
        args.clean_s = calibrate_clean_s(probe)
        log(f"[abgate] clean threshold {args.clean_s:.6f} s (3x the probe's median)")
    side_a = Side.parse("A", args.a)
    side_b = Side.parse("B", args.b)
    search_res = interleaved_search_gate(
        idx, qn, gt, k, side_a, side_b, reps=args.reps,
        max_attempts=args.max_attempts, clean_s=args.clean_s, probe=probe,
        log=log,
    )
    build_res = None
    if args.build_n:
        del idx
        xb = x[: args.build_n]
        build_res = interleaved_build_gate(
            xb, cfg, build_kw, build_kw, clean_s=args.clean_s, probe=probe,
            log=log,
        )
    verdict, lines = decide(search_res, build_res)
    header = (
        f"# Interleaved A/B gate (automated; no manual disposition)\n"
        f"# cmd: python -m diskann_tpu_torch.bench abgate --n {n} --nq {nq} "
        f"--a \"{args.a}\" --b \"{args.b}\" --reps {args.reps} "
        f"--clean-s {args.clean_s:.6f} --build-n {args.build_n}\n"
        f"# device: {_device_name(device)}\n"
        f"# interleaved A,B,A,B reps; every rep probe-bracketed; dirty reps "
        f"re-queued; verdict over probe-clean medians"
    )
    text = render_artifact(header, search_res, build_res, verdict, lines)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return EXIT[verdict]


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


if __name__ == "__main__":
    main()
