"""JSON-driven benchmark registry + A/B tolerance checking.

Replaces `diskann-benchmark-runner` (`src/registry.rs:18-116`,
`src/benchmark.rs:19-236`, `src/checker.rs`): benchmarks register under a
name, jobs are JSON objects ``{"benchmark": name, ...params}``, results are
structured JSON, and `check_tolerances` compares an A and B result set with
per-metric relative tolerances (the disk CI A/B gate,
`perf_test_inputs/disk-index-tolerances.json`)."""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable


@dataclasses.dataclass
class Benchmark:
    name: str
    fn: Callable[[dict], dict]
    description: str = ""


class Registry:
    def __init__(self):
        self._benchmarks: dict[str, Benchmark] = {}

    def register(self, name: str, fn: Callable[[dict], dict], description: str = ""):
        if name in self._benchmarks:
            raise ValueError(f"benchmark {name!r} already registered")
        self._benchmarks[name] = Benchmark(name, fn, description)

    def names(self) -> list[str]:
        return sorted(self._benchmarks)

    def run_job(self, job: dict) -> dict:
        name = job["benchmark"]
        if name not in self._benchmarks:
            raise KeyError(f"unknown benchmark {name!r}; have {self.names()}")
        t0 = time.time()
        result = self._benchmarks[name].fn(job)
        return {
            "benchmark": name,
            "job": {k: v for k, v in job.items() if k != "benchmark"},
            "wall_s": time.time() - t0,
            "result": result,
        }

    def run_jobs(self, jobs: list[dict]) -> list[dict]:
        return [self.run_job(j) for j in jobs]

    def run_file(self, path: str) -> list[dict]:
        with open(path) as f:
            spec = json.load(f)
        jobs = spec if isinstance(spec, list) else spec["jobs"]
        return self.run_jobs(jobs)


class PassFail:
    """Aggregated pass/fail over tolerance checks (`benchmark.rs` PassFail)."""

    def __init__(self):
        self.failures: list[str] = []
        self.checks = 0

    def check(self, ok: bool, msg: str):
        self.checks += 1
        if not ok:
            self.failures.append(msg)

    @property
    def passed(self) -> bool:
        return not self.failures


def check_tolerances(
    a: dict, b: dict, tolerances: dict, *, prefix: str = ""
) -> PassFail:
    """Relative A/B comparison with the reference's DIRECTIONAL semantics
    (`diskann-benchmark/src/disk_index/benchmarks.rs:239-276` check_metric):
    for higher-is-better metrics only a DROP beyond tolerance fails; for
    lower-is-better only a RISE fails; improvements always pass.

    `tolerances` maps dotted metric paths to either a bare float (legacy:
    symmetric |b-a|/|a| check) or an object
    ``{"tol": 0.10, "direction": "higher_is_better"|"lower_is_better"}``."""
    pf = PassFail()

    def dig(d: dict, dotted: str):
        cur: Any = d
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return None
            cur = cur[part]
        return cur

    for metric, spec in tolerances.items():
        if isinstance(spec, dict):
            tol = float(spec["tol"])
            direction = spec.get("direction", "symmetric")
        else:
            tol, direction = float(spec), "symmetric"
        va, vb = dig(a, metric), dig(b, metric)
        if va is None or vb is None:
            pf.check(False, f"{prefix}{metric}: missing in A or B")
            continue
        denom = max(abs(float(va)), 1e-30)
        change = (float(vb) - float(va)) / denom    # signed relative change
        if direction == "higher_is_better":
            ok = -change <= tol
        elif direction == "lower_is_better":
            ok = change <= tol
        else:
            ok = abs(change) <= tol
        pf.check(
            ok,
            f"{prefix}{metric}: A={va} B={vb} change={change:+.4f} "
            f"tol={tol} ({direction}) REGRESSION",
        )
    return pf
