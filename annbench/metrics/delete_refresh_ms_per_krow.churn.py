"""Host wall of the profiler's ``delete.refresh`` ranges (the fat-row refresh
of `graph/delete.inplace_delete`) per 1,000 rows deleted in the traced
sub-window: read from the profiler's trace, under its cost
(`annbench.port_spans`), not from the port's span records."""

from annbench import port_spans

LAYER = "delete repair (graph/delete.py)"
UNIT = "ms"
MOVES = "recall_at_10"


def read(run):
    return port_spans.ms_per_krow(run, "delete.refresh", "delete")
