"""The port's bench package against the JAX package's.

- The jax-free modules (`stats.py`, `registry.py`, `recall.py`) and the
  example job and tolerance files are copies, byte for byte.
- The registry and tolerance cases of `test_record_bench.py`, the golden
  rendering of `test_golden.py` (the same renderer, the same golden file)
  and the cases of `test_abgate.py`, on the port (a CPU index, a probe
  handed in).
- Each registry family at tiny sizes through both packages' registries,
  on the same numpy data (the reference's ``device_data=False``): equal
  result keys, equal non-float results, recall within 0.01 (timings are
  not compared).
- The CLI's ``list`` and ``check`` through both packages' ``main``: the
  same output and exit status.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from diskann_tpu.bench.__main__ import main as jmain
from diskann_tpu.bench.harness import default_registry as jregistry
from diskann_tpu_torch import GraphConfig, GraphIndex
from diskann_tpu_torch.bench.__main__ import main as tmain
from diskann_tpu_torch.bench.abgate import (
    Side, calibrate_clean_s, decide, interleaved_search_gate, render_artifact,
)
from diskann_tpu_torch.bench.harness import default_registry
from diskann_tpu_torch.bench.recall import average_precision, knn_recall_with_ties
from diskann_tpu_torch.bench.registry import Registry, check_tolerances
from test_golden import GOLDEN, render
from torch_port_helpers import CPU

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted(p.name for p in (ROOT / "diskann_tpu" / "bench" / "example").glob("*.json"))


# ------------------------------------------------------------------ copies
@pytest.mark.parametrize("path", ["stats.py", "registry.py", "recall.py"]
                         + [f"example/{name}" for name in EXAMPLES])
def test_copies_are_identical(path):
    got = (ROOT / "diskann_tpu_torch" / "bench" / path).read_bytes()
    assert got == (ROOT / "diskann_tpu" / "bench" / path).read_bytes(), path


def test_recall_helpers():
    rd = np.array([[0.1, 0.2, 0.3], [1.0, 2.0, 9.0]], np.float32)
    gd = np.array([[0.1, 0.2, 0.3], [1.0, 2.0, 3.0]], np.float32)
    assert knn_recall_with_ties(rd, gd, 3) == pytest.approx(5 / 6)
    assert average_precision(np.array([[1, 2, 3]]), np.array([[3, 1]])) == pytest.approx(
        (1 / 1 + 2 / 3) / 2)


# -------------------------------------------- test_record_bench counterparts
def test_registry_and_tolerances():
    reg = Registry()
    reg.register("toy", lambda job: {"qps": 100.0 * job.get("x", 1), "recall": 0.99})
    res = reg.run_job({"benchmark": "toy", "x": 2})
    assert res["result"]["qps"] == 200.0
    a = {"qps": 100.0, "recall": 0.99}
    assert check_tolerances(a, {"qps": 95.0, "recall": 0.99},
                            {"qps": 0.10, "recall": 0.01}).passed
    pf2 = check_tolerances(a, {"qps": 80.0, "recall": 0.99}, {"qps": 0.10})
    assert not pf2.passed and "qps" in pf2.failures[0]


def test_small_benchmark_job():
    res = default_registry().run_job({
        "benchmark": "graph-index", "device": "cpu",
        "n": 1200, "dim": 16, "n_queries": 50,
        "max_degree": 16, "l_build": 32, "search_l": [32],
        "device_data": False, "insert_batch_size": 512,
    })
    sweep = res["result"]["search"][0]
    assert sweep["recall"] >= 0.9
    assert sweep["qps"] > 0


def test_check_tolerances_directional():
    a = {"qps": 100.0, "lat": 10.0}
    hib = {"qps": {"tol": 0.10, "direction": "higher_is_better"}}
    lib = {"lat": {"tol": 0.15, "direction": "lower_is_better"}}
    assert check_tolerances(a, {"qps": 200.0}, hib).passed
    assert check_tolerances(a, {"qps": 91.0}, hib).passed
    assert not check_tolerances(a, {"qps": 85.0}, hib).passed
    assert check_tolerances(a, {"lat": 2.0}, lib).passed
    assert not check_tolerances(a, {"lat": 12.0}, lib).passed


def test_check_tolerances_headline_gate():
    tol = json.loads((ROOT / "diskann_tpu_torch" / "bench" / "example"
                      / "headline-tolerances.json").read_text())
    r1 = {"value": 14478.0, "extra": {"recall": 0.951, "build_points_per_s": 2969}}
    r2 = {"value": 52466.0, "extra": {"recall": 0.9536, "build_points_per_s": 3701}}
    assert check_tolerances(r1, r2, tol).passed
    assert not check_tolerances(r2, r1, tol).passed


# ------------------------------------------------- test_golden counterpart
def test_registry_output_golden():
    reg = Registry()
    reg.register("toy", lambda job: {"qps": 123.4, "recall": 0.99,
                                     "config": {"l": job["l"]}})
    results = reg.run_jobs([{"benchmark": "toy", "l": 10}, {"benchmark": "toy", "l": 20}])
    assert Path(GOLDEN).read_text() == render(results)


# ------------------------------------------------ test_abgate counterparts
@pytest.fixture(scope="module")
def small_index():
    rng = np.random.default_rng(7)
    n, d = 1500, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((32, d)).astype(np.float32)
    gt = np.argsort(((q[:, None, :] - x[None, :, :]) ** 2).sum(-1), axis=1)[:, :5]
    idx = GraphIndex.build(x, GraphConfig(max_degree=16, l_build=32),
                           insert_batch_size=512, build_mode="packed", packed_dp=16,
                           device=CPU)
    return idx, q, gt


def test_side_parse():
    s = Side.parse("B", "l=40,mh=6,rl=12,mtrunc=1,rcomp=bf16,unroll=0")
    assert s.attrs == {"merge_trunc": True, "router_compute": "bf16",
                       "unroll_hops": False}
    assert s.search == {"l_search": 40, "max_hops": 6, "rerank_l": 12}


def test_interleaved_gate_clean_pass(small_index):
    idx, q, gt = small_index
    res = interleaved_search_gate(
        idx, q, gt, 5, Side.parse("A", "l=32,mtrunc=0"), Side.parse("B", "l=32,mtrunc=1"),
        reps=2, max_attempts=4, clean_s=1e9, probe=lambda: 0.01,
    )
    for name in ("A", "B"):
        assert res[name]["clean_reps"] == 2
        assert res[name]["qps"] is not None
        assert res[name]["recall"] > 0.8
    verdict, lines = decide(res, None)
    assert verdict in ("PASS", "FAIL")
    assert abs(res["A"]["recall"] - res["B"]["recall"]) < 0.05
    text = render_artifact("# hdr", res, None, verdict, lines)
    assert "raw interleaved reps" in text and verdict in text


def test_interleaved_gate_requeues_dirty_reps(small_index):
    idx, q, gt = small_index
    a, b = Side.parse("A", "l=32"), Side.parse("B", "l=32")
    calls = {"n": 0}

    def flaky_probe():
        calls["n"] += 1
        return 9.9 if calls["n"] <= 4 else 0.01

    res = interleaved_search_gate(idx, q, gt, 5, a, b, reps=1, max_attempts=6,
                                  clean_s=1.0, probe=flaky_probe)
    assert res["A"]["clean_reps"] >= 1 and res["B"]["clean_reps"] >= 1
    assert any(not r["clean"] for r in res["A"]["reps"])
    res2 = interleaved_search_gate(idx, q, gt, 5, a, b, reps=1, max_attempts=2,
                                   clean_s=1.0, probe=lambda: 9.9)
    assert res2["A"]["qps"] is None
    assert decide(res2, None)[0] == "INDECISIVE"


def test_decide_fail_on_regression():
    search_res = {
        "A": {"recall": 0.99, "qps": 1000.0, "reps": [], "clean_reps": 3},
        "B": {"recall": 0.99, "qps": 700.0, "reps": [], "clean_reps": 3},
    }
    verdict, lines = decide(search_res, None)
    assert verdict == "FAIL" and any("qps" in m for m in lines)
    search_res["B"]["qps"] = 1500.0
    assert decide(search_res, None)[0] == "PASS"


def test_decide_build_metric():
    build_res = {
        "A": {"reps": [], "clean_reps": 2, "points_per_s": 5000.0},
        "B": {"reps": [], "clean_reps": 2, "points_per_s": 4800.0},
    }
    assert decide(None, build_res)[0] == "PASS"
    build_res["B"]["points_per_s"] = 4000.0
    assert decide(None, build_res)[0] == "FAIL"
    build_res["B"]["points_per_s"] = None
    assert decide(None, build_res)[0] == "INDECISIVE"


def test_clean_threshold_follows_the_probe():
    times = iter([0.002, 0.001, 0.003, 0.002, 0.002, 0.009, 0.001, 0.002, 0.004])
    assert calibrate_clean_s(lambda: next(times)) == pytest.approx(0.006)


# ------------------------------------------- every family through both
FAMILIES = {
    "graph-index": {"n": 800, "dim": 16, "n_queries": 32, "max_degree": 16,
                    "l_build": 32, "search_l": [24, 48], "insert_batch_size": 400},
    "flat": {"n": 3000, "dim": 16, "n_queries": 32},
    "filters": {"n": 800, "dim": 16, "n_queries": 32, "max_degree": 16,
                "l_build": 32, "predicate": "red & ~blue", "search_l": 64,
                "insert_batch_size": 400},
    "multi-vector": {"n_docs": 120, "tokens_per_doc": 8, "dim": 16, "n_queries": 8},
    "streaming": {"n": 800, "dim": 16, "n_queries": 32, "max_degree": 12,
                  "l_build": 24, "insert_batch_size": 200},
    "kernels": {"op": "pairwise", "m": 64, "n": 256, "dim": 32, "dtype": "bf16",
                "iters": 2},
}
KERNEL_OPS = [{"op": "expand_score", "b": 32, "r": 8, "dp": 16, "n_rows": 256, "iters": 2},
              {"op": "sort_merge", "b": 32, "l": 16, "c": 32, "iters": 2},
              {"op": "lut_score", "b": 16, "c": 32, "m": 8, "n_rows": 256, "iters": 2}]


def _agree(got, want, path="result"):
    """Equal structure and keys; ints, strings and bools equal; a float
    named like a recall within 0.01; other floats (timings) not compared."""
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            _agree(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _agree(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        if "recall" in path.rsplit(".", 1)[-1] or path.endswith("selectivity"):
            assert abs(got - want) <= 0.01, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_jax(family):
    job = {"benchmark": family, "seed": 0, **FAMILIES[family]}
    want = jregistry().run_job({**job, "device_data": False})
    got = default_registry().run_job({**job, "device": "cpu"})
    assert got["benchmark"] == want["benchmark"] == family
    _agree(got["result"], want["result"])
    if family == "graph-index":
        assert got["result"]["search"][-1]["recall"] >= 0.9


@pytest.mark.parametrize("job", KERNEL_OPS, ids=[j["op"] for j in KERNEL_OPS])
def test_kernel_ops_match_jax(job):
    want = jregistry().run_job({"benchmark": "kernels", **job})
    got = default_registry().run_job({"benchmark": "kernels", "device": "cpu", **job})
    _agree(got["result"], want["result"])
    assert all(v > 0 for v in got["result"].values())


# --------------------------------------------------------------- the CLI
def _cli(main, argv, capsys):
    try:
        main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def test_cli_list_matches_jax(capsys):
    got = _cli(tmain, ["list"], capsys)
    assert got == _cli(jmain, ["list"], capsys)
    assert got[1].split() == ["filters", "flat", "graph-index", "kernels",
                              "multi-vector", "streaming"]


@pytest.mark.parametrize("qps_b", [98.0, 80.0], ids=["pass", "fail"])
def test_cli_check_matches_jax(capsys, tmp_path, qps_b):
    tol = str(ROOT / "diskann_tpu_torch" / "bench" / "example" / "tolerances.json")
    a = {"qps": 100.0, "recall": 0.95, "mean_cmps": 300.0,
         "latency": {"mean_ms": 1.0, "p95_ms": 2.0}}
    b = {**a, "qps": qps_b}
    (tmp_path / "a.json").write_text(json.dumps(a))
    # the wrapped form of a result is unwrapped
    (tmp_path / "b.json").write_text(json.dumps({"cmd": "x", "rc": 0, "parsed": b}))
    argv = ["check", str(tmp_path / "a.json"), str(tmp_path / "b.json"), tol]
    got = _cli(tmain, argv, capsys)
    assert got == _cli(jmain, argv, capsys)
    assert got[0] == (0 if qps_b == 98.0 else 1)


def test_cli_run_on_the_cpu(capsys, tmp_path):
    jobs = tmp_path / "jobs.json"
    jobs.write_text(json.dumps([{"benchmark": "multi-vector", "n_docs": 40,
                                 "tokens_per_doc": 4, "dim": 8, "n_queries": 4}]))
    code, out = _cli(tmain, ["run", str(jobs), "--device", "cpu",
                             "-o", str(tmp_path / "out.json")], capsys)
    assert code == 0
    res = json.loads((tmp_path / "out.json").read_text())
    assert json.loads(out) == res
    assert res[0]["job"]["device"] == "cpu" and res[0]["result"]["n_docs"] == 40
