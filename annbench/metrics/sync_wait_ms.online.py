"""Host wall of the profiler's ``sync`` ranges (the port's waits on the card:
each hop flag read, the answers' copy back) per ``search`` range, each one
request, in the traced sub-window: read from the profiler's trace, under
its cost (`annbench.port_spans`), not from the port's counter."""

from annbench import port_spans

LAYER = "host orchestration (graph/index.py)"
UNIT = "ms"
MOVES = "recall_at_10"


def read(run):
    calls = port_spans.count(run, "search")
    if not calls or not port_spans.count(run, "sync"):
        return None
    return port_spans.seconds(run, "sync") * 1e3 / calls
