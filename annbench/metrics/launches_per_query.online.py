"""Kernels the card ran in the traced sub-window, per query served there
(the profiler's kernel events; copies and the benchmark's ranges aside)."""

LAYER = "host orchestration (graph/index.py)"
UNIT = "launches"
MOVES = "recall_at_10"


def read(run):
    t = run.trace
    return t["kernels"] / run.tracer.queries if t and run.tracer.queries else None
