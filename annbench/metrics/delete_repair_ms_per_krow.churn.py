"""Host wall of the profiler's ``delete.repair`` ranges (`graph/delete.
inplace_delete` from the mark to the drop: discovery and repair) per 1,000
rows deleted in the traced sub-window: read from the profiler's trace,
under its cost (`annbench.port_spans`), not from the port's span
records."""

from annbench import port_spans

LAYER = "delete repair (graph/delete.py)"
UNIT = "ms"
MOVES = "recall_at_10"


def read(run):
    return port_spans.ms_per_krow(run, "delete.repair", "delete")
