"""The cells at a size a CPU test run holds: every configuration's widths
(128-d float32, k=10) kept, the data, the pools and the batches cut, the
clusters fewer so that 3,000 rows still cluster, and the recall limits
lowered to what such an index reaches.  `with_held` adds the cells held
back from `BENCHMARK.json` (``annbench/held/``), which the tests run too."""

import json
from pathlib import Path

HELD = Path(__file__).resolve().parents[1] / "held"


def with_held(bench):
    """``bench`` with each file of ``annbench/held/`` laid over its spec: its
    configurations, cells and per-layer metrics added, and its cells added
    to the ``workloads`` of each metric it names in ``cell_joins``."""
    for path in sorted(HELD.glob("*.json")):
        held = json.loads(path.read_text())
        cells = [w["name"] for w in held["workloads"]]
        for kind in ("configs", "workloads", "per_layer"):
            bench.spec[kind] = bench.spec[kind] + held[kind]
        for m in bench.spec["end_to_end"] + bench.spec["per_layer"]:
            if m["name"] in held["cell_joins"]:
                m["workloads"] = m["workloads"] + cells
    return bench


SEARCH = {"config": {"data": {"n": 3000, "clusters": 64, "slice_rows": 3000},
                     "build": {"insert_batch_size": 512},
                     "serve": {"search_batch_size": 256, "attach_packed_dp": 64},
                     "limits": {"recall_at_10": {"min": 0.5}}}}
SMALL = {
    "sift1m.search-batch": dict(SEARCH, traffic={
        "query_pool": 1024, "cycle": [{"op": "search", "queries": 256}],
        "trace_seconds": 0.3}),
    "sift1m.search-online": dict(SEARCH, traffic={
        "query_pool": 1024, "arrivals": {"kind": "poisson", "rate_per_s": 40.0},
        "warmup_cycles": 4, "trace_seconds": 0.3}),
    "stream1m.churn": {
        "config": {"data": {"n": 3000, "clusters": 64, "slice_rows": 300},
                   "build": {"insert_batch_size": 512, "capacity": 3400},
                   "serve": {"search_batch_size": 256},
                   "limits": {"recall_min": {"min": 0.5}, "insert_miss": {"max": 0.2}}},
        "traffic": {"query_pool": 256, "trace_seconds": 0.3,
                    "cycle": [{"op": "delete", "rows": 300}, {"op": "insert", "rows": 300},
                              {"op": "search", "queries": 256}]}},
}

# the sharded cell, kept apart from SMALL (whose cases run on one card): the
# same widths, shards and overlap, each shard a worker process (a CPU one
# here, a card on a host with four)
SHARDED = {
    "sift6m.sharded4-search": {
        "config": {"data": {"n": 3000, "clusters": 64, "slice_rows": 1000},
                   "shards": {"count": 4},
                   "build": {"insert_call_rows": 512, "cap_round": 512},
                   "serve": {"attach_packed_dp": 64},
                   # such an index reaches ~0.93; the exchange left out ~0.54
                   "limits": {"recall_at_10": {"min": 0.8}}},
        "traffic": {"query_pool": 1024, "cycle": [{"op": "search", "queries": 256}],
                    "trace_seconds": 0.3}},
}

# the filtered cell, held back too: 192-d on the uint8 grid and all 200,386
# tags kept, 3,000 rows of 64 clusters; calls of 64 queries, since the port
# makes one call per distinct predicate among them
FILTERED = {
    "yfcc.filtered-batch": {
        "config": {"data": {"n": 3000, "clusters": 64, "slice_rows": 1000},
                   "build": {"insert_batch_size": 512},
                   "serve": {"search_batch_size": 256, "attach_packed_dp": 64},
                   "limits": {"recall_at_10": {"min": 0.5}}},
        "traffic": {"query_pool": 256, "cycle": [{"op": "search", "queries": 64}],
                    "warmup_cycles": 1, "trace_seconds": 0.3}},
}
