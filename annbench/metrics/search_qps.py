"""Queries answered in the window over the window's length: all the
search calls, whole, from the window's start to the end of the last."""

UNIT = "queries/s"


def read(run):
    w = run.window
    return w["queries"] / w["window_s"] if w["queries"] and w["window_s"] > 0 else None
