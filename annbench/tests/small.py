"""The cells at a size a CPU test run holds: every configuration's widths
(128-d float32, k=10) kept, the data, the pools and the batches cut, the
clusters fewer so that 3,000 rows still cluster, and the recall limits
lowered to what such an index reaches."""

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
