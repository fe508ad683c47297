"""The sharded cell (`annbench.system.Sharded`), held back from
`BENCHMARK.json` in ``annbench/held/`` and laid over it here
(`small.with_held`), at a small size (`small.SHARDED`): four shards in four
worker processes of the port's mesh, on the CPU here.  Its entries keep
the benchmark's contract; a run comes out correct with its metrics; each
fault the cell can have comes out not correct (the exchange between cards
left out of the merge, a merge without dedup, half a batch left out, an
answer altered); a worker that loads JAX stops the run; the new readers
read nothing without worker traces; inserts and deletes go through the
sharded index too.  On a host with four cards, the same run on the cards,
and the control there.

`Sharded` splits the host's cores over the caller and its workers (each
worker takes the caller's torch thread count), since a mesh of processes
each spinning every core runs the CPU build an order of magnitude
slower."""

import functools
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from annbench import manifest, run, system
from annbench.control import Reused
from annbench.faults import planted
from annbench.reference.flat import Exact
import test_annbench_manifest as contract
from small import SHARDED, with_held
from test_annbench_imports import JAX, _loaded_after

BENCH = with_held(manifest.Bench())
CELL = "sift6m.sharded4-search"
SEED = 2**31 + 177
NEW = ["mesh_walk_ms_per_call.sharded", "merge_ms_per_call.sharded",
       "card_busy_ms_per_kq.sharded", "shard_skew.sharded"]
CONTRACT = [contract.test_keys_and_sizes, contract.test_names_units_and_lines,
            contract.test_paths_and_command, contract.test_every_cell_one_chip_and_each_pair_once,
            contract.test_bounds, contract.test_one_layer_name_per_layer_and_readers_match,
            contract.test_roofline_names]


def _run(*, seed=SEED, trace=False, overrides=None, **kw):
    return run.run_cell(BENCH, CELL, seed=seed, seconds=0.5, trace=trace, device="cpu",
                        t0=time.perf_counter(), overrides=overrides or SHARDED[CELL], **kw)


@pytest.fixture(scope="module")
def built():
    """The sharded system of ``SEED``'s data, built by the first run that
    takes it and searched by the later ones."""
    reused = Reused()
    yield reused
    reused.shut()


def test_the_cell_is_held_back_from_the_benchmark():
    with pytest.raises(KeyError):
        manifest.Bench().cell(CELL)


def test_the_held_entries_keep_the_contract(monkeypatch):
    monkeypatch.setattr(contract, "BENCH", BENCH)
    monkeypatch.setattr(contract, "SPEC", BENCH.spec)
    cells = [w["name"] for w in BENCH.spec["workloads"]]
    monkeypatch.setattr(contract, "CELLS", cells)
    for check in CONTRACT:
        check()
    for cell in cells:
        contract.test_cell_reports_setup_another_and_a_layer(cell)
        contract.test_files_found_by_name(cell)
    for m in BENCH.spec["per_layer"]:
        contract.test_moves_reported_where_the_metric_is(m["name"])


def test_the_cell_config_and_metrics_resolve():
    cell = BENCH.cell(CELL)
    assert cell["chips"] == 4 and cell["traffic"] == "closed-batch8192"
    cfg = BENCH.config(cell["config"])
    assert cfg["shards"] == {"count": 4, "partition": "kmeans", "overlap": 2,
                             "shards_per_card": 1}
    assert "insert_batch_size" not in cfg["build"]     # the one-card Port refuses it
    assert {m["name"] for m in BENCH.metrics(CELL, "end_to_end")} == {
        "search_qps", "recall_at_10", "setup_s"}
    assert {m["name"] for m in BENCH.metrics(CELL, "per_layer")} == set(NEW) | {
        "fatrow_expand_roofline"}
    for name in NEW:
        assert manifest.reader(name).MOVES == "search_qps"


def test_the_one_card_port_refuses_the_config_before_building():
    cfg = manifest.merge(BENCH.config("sift6m-sharded4"), SHARDED[CELL]["config"])
    with pytest.raises(KeyError):
        system.Port(cfg, torch.zeros((8, 128)))


def test_a_sharded_run_is_correct_with_its_end_to_end_metrics():
    res, rows = _run()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, rows
    assert set(res["metrics"]) == {"search_qps", "recall_at_10", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["device"]["count"] == 4


def test_a_traced_sharded_run_reads_the_worker_traces(built):
    res, rows = _run(trace=True, make_system=built)
    assert res["correct"], rows
    # the host-clock readers read the CPU run; the device ones need a card
    assert {"mesh_walk_ms_per_call.sharded", "merge_ms_per_call.sharded"} <= set(
        res["metrics"]) <= set(NEW) | {"fatrow_expand_roofline"}
    assert res["metrics"]["mesh_walk_ms_per_call.sharded"]["value"] > 0
    assert {"busy_s", "window_s"} <= set(res["device"]) and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", ["exchange-drop", "merge-no-dedup", "half-batch",
                                   "alter-answer"])
def test_each_fault_comes_out_not_correct(built, fault):
    with planted(fault):
        res, rows = _run(make_system=built)
    assert not res["correct"], rows


def test_a_worker_that_loads_jax_stops_the_run():
    def planted(cfg, base):
        made = system.make(cfg, base)
        made.on_cards(exec, "import jax", {})
        return made
    had = "jax" in sys.modules
    with pytest.raises(run.Forbidden, match="jax"):
        _run(make_system=planted)
    assert ("jax" in sys.modules) == had     # only the workers loaded it


def test_the_control_fails():
    res, rows = _run(make_system=functools.partial(Exact, precision="tf32"))
    assert not res["correct"]
    assert not next(r for r in rows if r["name"] == "dist_gap")["ok"]


def test_inserts_and_deletes_go_through_the_sharded_index():
    over = manifest.merge(SHARDED[CELL], {
        "config": {"limits": {"insert_miss": {"max": 0.2}}},
        "traffic": {"query_pool": 256, "cycle": [
            {"op": "delete", "rows": 300}, {"op": "insert", "rows": 300},
            {"op": "search", "queries": 256}]}})
    res, rows = _run(overrides=over)
    assert res["correct"], rows
    assert res["checks"]["insert_miss"]["value"] is not None


def test_a_sharded_run_loads_no_jax():
    code = ("import sys, time, torch; sys.path.insert(0, 'annbench/tests')\n"
            "from annbench import manifest, run\nfrom small import SHARDED, with_held\n"
            f"res, _ = run.run_cell(with_held(manifest.Bench()), {CELL!r}, seed=5, seconds=0.2,"
            " trace=False, device='cpu', t0=time.perf_counter(),"
            f" overrides=SHARDED[{CELL!r}])\nassert res['correct']")
    got = _loaded_after(code)
    assert "diskann_tpu_torch" in got
    assert not got & JAX


def test_the_new_readers_read_none_without_worker_traces():
    window = {"spans": [("search", 0.0, 1.0, 8)], "window_s": 1.0, "queries": 8}
    for trace in (None, {"busy_s": 0.0, "wall_s": 1.0}):
        r = SimpleNamespace(window=window, trace=trace, tracer=SimpleNamespace(queries=8))
        for name in NEW:
            assert manifest.reader(name).read(r) is None, name


@pytest.mark.cuda
def test_a_sharded_run_on_four_cards_is_correct_and_the_control_not(card):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    over = manifest.merge(SHARDED[CELL], {"config": {"shards": {"count": 4}}})
    kw = dict(seed=SEED, seconds=0.5, trace=True, device=card, overrides=over)
    res, rows = run.run_cell(BENCH, CELL, t0=time.perf_counter(), **kw)
    assert res["correct"], rows
    assert set(NEW) | {"fatrow_expand_roofline"} <= set(res["metrics"])
    assert 0 < res["metrics"]["fatrow_expand_roofline"]["value"] <= 105
    assert res["device"]["busy_s"] > 0 and res["device"]["memory_peak_bytes"] > 0
    assert all(n.startswith("cuda:") for n, _ in res["breakdown"]["device_ops"])
    res, rows = run.run_cell(BENCH, CELL, t0=time.perf_counter(),
                             make_system=functools.partial(Exact, precision="tf32"), **kw)
    assert not res["correct"]
