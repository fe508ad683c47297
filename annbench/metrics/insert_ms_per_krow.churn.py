"""Host wall of the window's GraphIndex.insert calls (the benchmark's span
around each), per 1,000 rows."""

LAYER = "insert batch (graph/build.py, graph/prune.py)"
UNIT = "ms"
MOVES = "recall_at_10"


def read(run):
    spans = [(end - start, size) for op, start, end, size in run.window["spans"]
             if op == "insert"]
    rows = sum(size for _, size in spans)
    return sum(s for s, _ in spans) * 1e3 / (rows / 1e3) if rows else None
