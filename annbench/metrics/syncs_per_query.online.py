"""The profiler's ``sync`` ranges (the port's waits on the card: each hop flag
read, the answers' copy back) per query of the traced sub-window: read from
the profiler's trace (`annbench.port_spans`), not from the port's
counter."""

from annbench import port_spans

LAYER = "host orchestration (graph/index.py)"
UNIT = "syncs"
MOVES = "recall_at_10"


def read(run):
    n = port_spans.count(run, "sync")
    return n / run.tracer.queries if n and run.tracer.queries else None
