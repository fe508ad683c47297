"""Host wall of the profiler's ``search.walk`` ranges (the port's hop-loop
span, its flag reads included) per ``search`` range, each one request, in
the traced sub-window: read from the profiler's trace, under its cost
(`annbench.port_spans`), not from the port's span records."""

from annbench import port_spans

LAYER = "hop loop and packed scorer (graph/search.py, graph/scorers.py, graph/packed.py)"
UNIT = "ms"
MOVES = "recall_at_10"


def read(run):
    calls = port_spans.count(run, "search")
    if not calls or not port_spans.count(run, "search.walk"):
        return None
    return port_spans.seconds(run, "search.walk") * 1e3 / calls
