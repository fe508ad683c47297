"""Nodes expanded per query over the window (the port's SearchStats.hops)."""

LAYER = "hop loop and packed scorer (graph/search.py, graph/scorers.py, graph/packed.py)"
UNIT = "hops"
MOVES = "search_qps"


def read(run):
    w = run.window
    return w["hops"] / w["queries"] if w["queries"] else None
