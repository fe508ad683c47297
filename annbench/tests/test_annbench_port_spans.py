"""The readers of the port's own spans (`annbench/port_spans.py` and the
metrics that read it through it): each cell's traced CPU run reports them;
a program that opens no such ranges reads None from every one of them; and
a port range is a function-scope range, so `Traced.summary` counts no
kernel and no busy time for it (on the card: exactly the kernels)."""

import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from annbench import manifest, run
from annbench.tracing import Traced
from small import SMALL

BENCH = manifest.Bench()
ROOT = Path(__file__).resolve().parents[2]
# the readers of the port's host ranges; the two others read device time
HOST_RANGES = ["walk_host_ms.online", "sync_wait_ms.online", "syncs_per_query.online",
               "insert_candidates_ms_per_krow.churn", "insert_edges_ms_per_krow.churn",
               "delete_repair_ms_per_krow.churn", "delete_refresh_ms_per_krow.churn"]
NEW = ["router_device_ms_per_kq.search", "rerank_device_ms_per_kq.search"] + HOST_RANGES


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_cpu_run_reports_the_port_span_readers(cell):
    res, _ = run.run_cell(BENCH, cell, seed=2**31 + 91, seconds=0.5, trace=True,
                          device="cpu", t0=time.perf_counter(), overrides=SMALL[cell])
    assert res["correct"]
    want = {m["name"] for m in BENCH.metrics(cell, "per_layer")} & set(HOST_RANGES)
    assert want <= set(res["metrics"])
    assert all(res["metrics"][n]["value"] > 0 for n in want)
    if cell == "sift1m.search-online":
        # a one-query request: at most max_hops (6) flag reads and one fetch
        assert 1 < res["metrics"]["syncs_per_query.online"]["value"] <= 7


def _traced_run(device, body) -> SimpleNamespace:
    with Traced(device) as tracer:
        body()
    tracer.queries = 8
    return SimpleNamespace(trace=tracer.summary(), tracer=tracer, window={"spans": [
        ("delete", 0.0, 1.0, 100), ("insert", 1.0, 2.0, 100), ("search", 2.0, 3.0, 8)]})


def test_without_the_port_ranges_every_new_reader_reads_none():
    r = _traced_run(torch.device("cpu"), lambda: torch.ones(64).cumsum(0))
    assert set(NEW) <= {m["name"] for m in BENCH.spec["per_layer"]}
    for name in NEW:
        assert manifest.reader(name).read(r) is None, name


def _port_span_around(device):
    from diskann_tpu_torch import trace

    a = torch.randn(256, 256, device=device)

    def body():
        with trace.span("search.walk"):
            (a @ a).sum()
    return _traced_run(device, body)


def test_a_port_range_is_a_host_range_and_no_kernel():
    r = _port_span_around(torch.device("cpu"))
    (ev,) = [e for e in r.tracer._prof.events() if e.name == "search.walk"]
    assert not ev.is_user_annotation       # no device-side twin on a card
    assert r.trace["kernels"] == 0 and "search.walk" not in r.trace["kernel_s"]


CARD_CHECK = """
import json, sys, torch
sys.path[:0] = [".", "annbench/tests"]
from test_annbench_port_spans import _port_span_around
r = _port_span_around(torch.device("cuda:0"))
dev = [e for e in r.tracer._prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
print(json.dumps({"dev": [e.name for e in dev], "kernels": r.trace["kernels"],
                  "walk_s": r.trace["ranges_device_s"].get("search.walk", 0.0)}))
"""


@pytest.mark.cuda
def test_a_port_range_counts_no_kernel_on_the_card(card):
    # in a process of its own: after other profiles in one process,
    # a short profile on the card can come back with no device events
    p = subprocess.run([sys.executable, "-c", CARD_CHECK], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["dev"] and "search.walk" not in got["dev"]
    kernels = [n for n in got["dev"] if not n.startswith(("Memcpy", "Memset"))]
    assert got["kernels"] == len(kernels) and got["walk_s"] > 0
