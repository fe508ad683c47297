"""Rows deleted plus rows inserted in the window, over the window's
length; the window holds whole cycles, the checkpoint searches with them."""

UNIT = "rows/s"


def read(run):
    w = run.window
    rows = sum(size for op, _, _, size in w["spans"] if op in ("insert", "delete"))
    return rows / w["window_s"] if rows and w["window_s"] > 0 else None
