"""`BENCHMARK.json` against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from annbench import driver, manifest

BENCH = manifest.Bench()
SPEC = BENCH.spec
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(SPEC) == KEYS["top"]
    assert len(json.dumps(SPEC)) <= 64 * 1024
    for kind, lo, hi in (("configs", 1, 24), ("workloads", 1, 24), ("end_to_end", 1, 16),
                         ("per_layer", 1, 128)):
        assert lo <= len(SPEC[kind]) <= hi
        for entry in SPEC[kind]:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
            assert KEYS[kind] <= set(entry) <= KEYS[kind] | extra, entry["name"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_lines():
    names = {}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in SPEC[kind]]
        assert len(got) == len(set(got)), kind
        names[kind] = got
        for n in got:
            assert NAME.match(n), n
    for kind in ("end_to_end", "per_layer"):
        for m in SPEC[kind]:
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
    assert not set(names["end_to_end"]) & set(names["per_layer"])
    for c in SPEC["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert _line(w["why"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in SPEC["per_layer"]:
        assert _line(m["layer"])


def test_paths_and_command():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"]), word
    for c in SPEC["configs"]:
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])


def test_every_cell_one_chip_and_each_pair_once():
    # one chip, but for at most a quarter of the cells (rounded down), or one
    # cell, on four: those whose state exists only across cards
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


def test_budget_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_and_a_layer(cell):
    e2e = {m["name"] for m in BENCH.metrics(cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert BENCH.metrics(cell, "per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_moves_reported_where_the_metric_is(metric):
    m = next(x for x in SPEC["per_layer"] if x["name"] == metric)
    assert m["moves"] in {x["name"] for x in SPEC["end_to_end"]}
    cells = m.get("workloads", CELLS)
    assert cells and set(cells) <= set(CELLS)
    for cell in cells:
        assert m["moves"] in {x["name"] for x in BENCH.metrics(cell, "end_to_end")}, cell


def test_one_layer_name_per_layer_and_readers_match():
    for m in SPEC["per_layer"]:
        r = manifest.reader(m["name"])
        assert (r.LAYER, r.UNIT, r.MOVES) == (m["layer"], m["unit"], m["moves"]), m["name"]
    for m in SPEC["end_to_end"]:
        assert manifest.reader(m["name"]).UNIT == m["unit"]


@pytest.mark.parametrize("cell", CELLS)
def test_files_found_by_name(cell):
    w = BENCH.cell(cell)
    cfg = BENCH.config(w["config"])
    assert cfg["name"] == w["config"]
    entry = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert entry["reduced"] == cfg["reduced"]
    assert cfg["assumed"] and cfg["guarantees"] and cfg["limits"]
    driver.validate(BENCH.traffic(w["traffic"]))


def test_roofline_names():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
