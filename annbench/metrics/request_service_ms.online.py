"""The host wall of one search call, queue wait excluded: the calls'
summed service time over the window's count of calls, so the time read
spans the whole window."""

LAYER = "host orchestration (graph/index.py)"
UNIT = "ms"
MOVES = "recall_at_10"


def read(run):
    s = run.window["service"]
    return sum(s) / len(s) * 1e3 if s else None
