"""Host wall of the profiler's ``insert.edges`` ranges (phase 3 of
`graph/build.insert_batch_steps`: out-edges, backedges, re-prune) per
1,000 rows inserted in the traced sub-window: read from the profiler's
trace, under its cost (`annbench.port_spans`), not from the port's span
records."""

from annbench import port_spans

LAYER = "insert batch (graph/build.py, graph/prune.py)"
UNIT = "ms"
MOVES = "recall_at_10"


def read(run):
    return port_spans.ms_per_krow(run, "insert.edges", "insert")
