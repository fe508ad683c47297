"""Host wall of the window's GraphIndex.delete calls (the benchmark's span
around each), per 1,000 rows."""

LAYER = "delete repair (graph/delete.py)"
UNIT = "ms"
MOVES = "recall_at_10"


def read(run):
    spans = [(end - start, size) for op, start, end, size in run.window["spans"]
             if op == "delete"]
    rows = sum(size for _, size in spans)
    return sum(s for s, _ in spans) * 1e3 / (rows / 1e3) if rows else None
