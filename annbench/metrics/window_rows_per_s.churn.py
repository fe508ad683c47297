"""Rows deleted plus rows inserted in the window, over the window's
length; the window holds whole cycles, the checkpoint searches with them.
Read per layer: the host's speed from process to process spreads it by
more than an end-to-end bound may hold (PERF.md, section 2)."""

LAYER = "host orchestration (graph/index.py)"
UNIT = "rows/s"
MOVES = "recall_at_10"


def read(run):
    w = run.window
    rows = sum(size for op, _, _, size in w["spans"] if op in ("insert", "delete"))
    return rows / w["window_s"] if rows and w["window_s"] > 0 else None
