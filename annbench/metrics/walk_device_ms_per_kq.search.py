"""Device time of the kernels launched inside the hop loop
(beam_search_scored, in the benchmark's range) per 1,000 queries of the
traced sub-window."""

LAYER = "hop loop and packed scorer (graph/search.py, graph/scorers.py, graph/packed.py)"
UNIT = "ms"
MOVES = "search_qps"


def read(run):
    t = run.trace
    if not t or "annbench.walk" not in t["ranges_device_s"] or not run.tracer.queries:
        return None
    return t["ranges_device_s"]["annbench.walk"] * 1e3 / (run.tracer.queries / 1e3)
