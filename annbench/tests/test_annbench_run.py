"""Whole runs on the CPU at a small size (`small.py`): every cell correct,
the result line's shape, each fault of `annbench.faults` and the control
caught, and the run's refusals (no card, forbidden modules)."""

import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from annbench import manifest, run
from annbench.faults import planted
from annbench.reference.flat import Exact
from small import SMALL

BENCH = manifest.Bench()
ROOT = Path(__file__).resolve().parents[2]
LAST_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(cell, *, seed=2**31 + 77, seconds=0.5, trace=False, **kw):
    return run.run_cell(BENCH, cell, seed=seed, seconds=seconds, trace=trace,
                        device="cpu", t0=time.perf_counter(), overrides=SMALL[cell], **kw)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_runs_correct_with_its_end_to_end_metrics(cell):
    res, rows = _run(cell)
    assert list(res) == LAST_KEYS
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in BENCH.metrics(cell, "end_to_end")}
    assert set(res["metrics"]) == want
    for m in BENCH.metrics(cell, "end_to_end"):
        assert res["metrics"][m["name"]]["unit"] == m["unit"]
        assert res["metrics"][m["name"]]["value"] > 0
    assert set(res["checks"]) == {r["name"] for r in rows}
    for r in rows:
        assert res["checks"][r["name"]] == {"value": r["value"], "limit": r["limit"]}
    json.dumps(res)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_run_reports_the_cells_per_layer_metrics(cell):
    res, _ = _run(cell, trace=True)
    assert list(res) == LAST_KEYS[:5] + ["breakdown", "checks"]
    assert res["correct"]
    assert {"busy_s", "window_s"} <= set(res["device"]) and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    got = set(res["metrics"])
    # the host-clock and counter readers read the CPU run; device readers need the card
    layer = BENCH.metrics(cell, "per_layer")
    assert {m["name"] for m in layer if m["source"] in ("host_clock", "program_counter")} <= got
    assert got <= {m["name"] for m in layer}


@pytest.mark.parametrize("cell,fault", [
    ("stream1m.churn", "insert-noop"),
    ("stream1m.churn", "insert-drop"),
    ("stream1m.churn", "delete-noop"),
    ("stream1m.churn", "half-batch"),
    ("stream1m.churn", "alter-answer"),
    ("sift1m.search-batch", "half-batch"),
    ("sift1m.search-batch", "alter-answer"),
])
def test_each_fault_comes_out_not_correct(cell, fault):
    with planted(fault):
        res, rows = _run(cell)
    assert not res["correct"], rows


@pytest.mark.parametrize("cell", ["sift1m.search-batch", "stream1m.churn"])
def test_the_control_fails_and_the_reference_in_float32_passes(cell):
    res, rows = _run(cell, make_system=functools.partial(Exact, precision="tf32"))
    assert not res["correct"]
    assert not next(r for r in rows if r["name"] == "dist_gap")["ok"]
    res, rows = _run(cell, make_system=functools.partial(Exact, precision="float32"))
    assert res["correct"], rows


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "diskann_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxlike.sub", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "diskann_tpu.graph", object())
    assert run.forbidden_modules() == ["diskann_tpu", "jax"]


def test_a_run_without_a_card_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, "annbench/run.py", "--workload",
                        "sift1m.search-batch", "--seed", "3000000000", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""
